"""Uniform random u8 levels in ``0 .. high - 1``: the README quickstart's
``default_rng(seed).integers(0, 254)`` drawn on the device (a frozen copy
of the recipe in ``tools/torch_ab.py::_fields``)."""

import torch


def make(shape, field, gen):
    return torch.randint(0, int(field["high"]), shape, generator=gen, device=gen.device, dtype=torch.uint8)
