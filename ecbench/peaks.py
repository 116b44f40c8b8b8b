"""Published peaks of the cards the benchmark runs on, by the name
torch.cuda.get_device_name() gives (NVIDIA's H100 data sheet, SXM part)."""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
