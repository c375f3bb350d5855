"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates, at the full 700 W power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_flops_per_s": 67e12,     # outside the tensor cores
    },
}


def peak(ctx, key: str):
    """The run's card's ``key`` peak, or None off the card or for a card
    not in the table."""
    import torch
    if ctx.device.type != "cuda":
        return None
    return PEAKS.get(torch.cuda.get_device_name(ctx.device), {}).get(key)
