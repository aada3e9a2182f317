"""Inputs from ``--seed``: the one generator that every traffic mix's
parameters go through.

A traffic mix's ``field`` names its kind (``fields/<kind>.py``, whose
``make(shape, field, gen)`` draws one u8 image) and, when ``nan_frac`` is
set, its NaN layout (``masks/<layout>.py``, whose ``make(shape, field,
gen)`` draws the pixels that are NaN, set to NEVER_FILL as the reference
``pre_processor`` maps NaN).  Each pool image is drawn on the device from
a ``torch.Generator`` there, seeded from ``SeedSequence([seed mod 2**64,
image index])``, in a few whole-image calls: every seed gives the same
sizes, and one seed the same pixels on the same kind of device."""

from __future__ import annotations

import numpy as np
import torch

NEVER_FILL = 255


def image_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for pool image ``index`` of ``--seed``."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), int(index)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_image(cell, shape, field: dict, seed: int, index: int, device) -> torch.Tensor:
    """Pool image ``index``: a u8 tensor of ``shape`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(image_seed(seed, index))
    img = cell.module("fields", field["kind"]).make(tuple(shape), field, gen)
    if float(field.get("nan_frac", 0.0)):
        img[cell.module("masks", field["nan_layout"]).make(tuple(shape), field, gen)] = NEVER_FILL
    return img


def make_pool(cell, seed: int, device, shape=None) -> list:
    """``traffic["pool"]`` images of the cell's shape (or ``shape``), on
    ``device``."""
    shape = tuple(shape or cell.config["shape"])
    return [make_image(cell, shape, cell.traffic["field"], seed, i, device) for i in range(int(cell.traffic["pool"]))]
