"""NVIDIA H100 SXM5 peaks, from NVIDIA's H100 Tensor Core GPU data sheet
(SXM5 column, dense rates). A frozen copy of the constants of
``src/repro_torch/core/h100.py`` and ``chip_smoke.py``
(``FP32_FLOP_PER_S``, ``HBM_BYTES_PER_S``). The rates assume the card's
full 700 W power limit; every result names the card and its limit beside
them."""

PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # dense TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12     # dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3
HBM_BYTES = 80 * 10 ** 9
