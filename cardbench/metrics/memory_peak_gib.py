"""Peak of the device memory the program allocated over the run
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30
