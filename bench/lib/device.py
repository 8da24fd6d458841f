"""What the drivers ask of the device they run on: the card, or the CPU
where the tests drive a run at a tiny size."""

import time

import torch


def is_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if is_card(device):
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The most memory the process has held on the card (0 on the CPU)."""
    return torch.cuda.max_memory_allocated(device) if is_card(device) else 0


def free_cache(device) -> None:
    if is_card(device):
        torch.cuda.empty_cache()


def stamp(device):
    """A point in the device's queue, taken without waiting: a recorded
    CUDA event on the card, the host clock on the CPU (which has done
    all the work before it)."""
    if is_card(device):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def between_ms(stamps) -> list:
    """The milliseconds between successive stamps, once the device has
    passed the last."""
    if stamps and isinstance(stamps[0], float):
        return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
