"""Published peaks of the chips the benchmark reads rooflines against
(NVIDIA's data sheet, H100 SXM5, dense rates at the full 700 W)."""

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "tf32_flops": 495e12,
}
