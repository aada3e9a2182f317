"""The coarse merging tail's rounds in blocks (``scan_merge._coarse_rounds``)
on the plain twins: each round after the first stops when the round before
it changed nothing (``go``), the host reads one block of change counts
while the next block is queued, and the loop ends at the first block that
holds a quiet round.  The labels and ``rounds`` must equal those of the
loop that reads every round's count; ``coarse_round_plain`` counts the
rounds that ran, ``coarse_round_skipped`` those that stopped."""

import math

import pytest
import torch

from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import scan_merge as sm
from torch_fields import serpentine

K = sm._TAIL_BLOCK


def _needing(rounds: int) -> torch.Tensor:
    """A label plane whose coarse fixed point takes ``rounds`` rounds, the
    quiet one included: the serpentine corridor of ``2 * (rounds + 1)``
    rows (one coarse round a turn; 4 rows hold one cell, already quiet)."""
    return torch.from_numpy(serpentine(2 * (rounds + 1), 12))


def _round_by_round(lab):
    """The coarse rounds with one read a round: ``(plane, rounds)``."""
    c, rounds = sm.coarsen_plain(lab), 0
    while True:
        c, changed = sm.coarse_round_plain(c)
        rounds += 1
        if changed.item() == 0:
            return c, rounds


CASES = [(k, r) for k in (K, 3) for r in (1, k - 1, k, k + 1, 5 * k + 2)]


@pytest.mark.parametrize("k,need", CASES, ids=[f"k{k}-rounds{r}" for k, r in CASES])
def test_blocked_rounds_match_the_round_by_round_loop(monkeypatch, k, need):
    monkeypatch.setattr(sm, "_TAIL_BLOCK", k)
    lab = _needing(need)
    want_c, want_rounds = _round_by_round(lab)
    assert want_rounds == need
    _ext.reset_launches()
    got, rounds = sm.component_min_coarse(lab, 1 << 20)
    n = _ext.launches
    assert torch.equal(got, sm.component_min_labels_plain(lab))
    assert torch.equal(got, sm.coarse_broadcast_plain(want_c, lab))
    assert rounds == need and n["coarse_round_plain"] == need
    blocks = math.ceil(need / k)  # the blocks read: the last holds the quiet round
    assert n["host_reads"] == blocks
    assert n["coarse_round_skipped"] == (blocks + 1) * k - need  # the rest of the last block and the next
    assert k <= n["coarse_round_skipped"] <= 2 * k - 1
    assert n["coarse_round"] == n["coarse_round_launched"] == 0  # the kernel's counters: no kernel ran


def test_a_round_whose_go_is_zero_leaves_the_plane():
    """``go`` 0: the plane stays, ``changed`` reads 0 and the round counts
    as skipped; ``go`` nonzero: the round that ``go=None`` runs; with
    ``go`` the round runs in place."""
    c = sm.coarsen_plain(_needing(5))
    before = c.clone()
    changed = torch.full((1,), 7, dtype=torch.int32)
    _ext.reset_launches()
    out, got = sm.coarse_round_plain(c, out=c, go=torch.zeros((1,), dtype=torch.int32), changed=changed)
    assert out is c and torch.equal(c, before) and got is changed and changed.item() == 0
    assert _ext.launches["coarse_round_skipped"] == 1 and _ext.launches["coarse_round_plain"] == 0
    want, want_n = sm.coarse_round_plain(before.clone())
    out, got = sm.coarse_round_plain(c, out=c, go=torch.ones((1,), dtype=torch.int32), changed=changed)
    assert torch.equal(out, want) and got.item() == want_n.item() > 0
    assert _ext.launches["coarse_round_plain"] == 2 and _ext.launches["coarse_round_skipped"] == 1
    with pytest.raises(ValueError, match="in place"):
        sm.coarse_round_plain(c, go=torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="one-element int32"):
        sm.coarse_round_plain(c, out=c, go=torch.ones((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match="must not be its go"):
        sm.coarse_round_plain(c, out=c, go=changed, changed=changed)
