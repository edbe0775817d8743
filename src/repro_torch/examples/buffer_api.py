"""The buffer-centric UnifiedMemory front-end: one typed code path, three
memory-management policies (docs/memspace.md).

A toy CPU-init streaming app sums a 4 MiB matrix's rows into an
accumulator with torch on ``--device`` (the CUDA card by default), while
the runtime charges the same op stream under each policy. The charges
depend on the buffers' shapes and dtypes, not on the values or the device.

    PYTHONPATH=src python -m repro_torch.examples.buffer_api [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (
    Actor,
    UnifiedMemory,
    explicit_policy,
    managed_policy,
    system_policy,
)
from repro_torch.kernels.common import resolve_device

KB, MB = 1024, 1024 * 1024


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a UMBuffer is typed with, for a torch dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def stream_app(pol, device, page_size=64 * KB):
    """A toy CPU-init streaming app — note: no policy branches, no byte math."""
    um = UnifiedMemory(staging_page_size=page_size)
    f32 = np_dtype(torch.float32)
    data_m = um.from_host("data", (4096, 256), f32, pol)  # 4 MiB
    acc_m = um.array("acc", (256,), f32, pol)

    with um.phase("cpu_init"):
        data = torch.arange(4096 * 256, dtype=torch.float32).reshape(4096, 256)
        um.launch("init", writes=[data_m[:]], actor=Actor.CPU)

    with um.staged(h2d=[data_m], d2h=[acc_m]):
        data = data.to(device)
        acc = torch.zeros(256, dtype=torch.float32, device=device)
        with um.phase("compute"):
            for r0 in range(0, 4096, 1024):
                acc += data[r0:r0 + 1024].sum(dim=0)
                um.launch(f"rows{r0}",
                          reads=[data_m.rows(r0, r0 + 1024)],  # row band -> extent
                          writes=[acc_m[:]],
                          flops=2.0 * 1024 * 256, actor=Actor.GPU)
                um.sync()

    with um.phase("dealloc"):
        um.free_live()
    return um, acc.cpu()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the app's math; default: the CUDA card")
    dev = resolve_device(ap.parse_args(argv).device)
    print(f"{'policy':9s} {'total ms':>9s} {'h2d MiB':>8s} {'remote MiB':>10s}")
    for name, pol in [("explicit", explicit_policy()),
                      ("managed", managed_policy(64 * KB)),
                      ("system", system_policy(64 * KB))]:
        um, acc = stream_app(pol, dev)
        rep = um.report()
        tr = rep["traffic_total"]
        print(f"{name:9s} {sum(rep['phase_times_s'].values())*1e3:9.3f} "
              f"{tr['link_h2d']/MB:8.2f} {tr['remote_h2d']/MB:10.2f}")
    print(f"acc[:2] = {acc[:2].tolist()} on {dev}")

    # views resolve to exact byte extents — the same math the raw API used
    um = UnifiedMemory()
    buf = um.array("m", (128, 64), np_dtype(torch.float32),
                   system_policy(4 * KB))
    band = buf.rows(3, 17)
    print(f"\n{band!r} -> bytes [{band.lo}, {band.hi}), "
          f"pages {band.page_extent()}")


if __name__ == "__main__":
    main()
