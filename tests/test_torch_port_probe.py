"""The source edits of ``chip_slot_attention_probe.py``, on the CPU.

The probe builds edited copies of ``textocvp_tpu_torch/csrc/slot_attention.cu``
on the card (clusters of 16 CTAs; clock reads at each phase). Its edits find
their places by exact text, so they are applied here to the current source:
an edit of the kernel that moves one of those places fails here, not on the
card.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_slot_attention_probe as probe  # noqa: E402
from textocvp_tpu_torch.ops import build  # noqa: E402

SOURCE = (build.CSRC / "slot_attention.cu").read_text()


def test_clusters_of_16_edit_applies():
    text = probe.clusters_of_16(SOURCE)
    assert "constexpr int C = 16;" in text and "constexpr int C = 8;" not in text
    assert text.count("cudaFuncAttributeNonPortableClusterSizeAllowed") == 1
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" not in SOURCE


def test_clock_edit_marks_each_cluster_sync_and_the_tile_loop():
    text = probe.with_clocks(SOURCE)
    syncs = sum(line.strip().startswith("cluster.sync();") for line in SOURCE.splitlines())
    assert syncs > 0
    # one mark at the kernel's start, one after each K/V tile loop, one after each sync
    assert text.count(probe.MARK) == syncs + 2
    assert 'extern "C" int sa_read_clocks' in text
    # marks a call: the start, the two before the loop, then 7 an iteration but the last's 6
    iters = probe.PHASE_ITERS
    assert 1 + 2 + len(probe.PHASES) * iters - 1 <= probe.EVENTS


def test_an_edit_whose_place_is_gone_raises():
    with pytest.raises(RuntimeError, match="not found once"):
        probe.clusters_of_16(SOURCE.replace("constexpr int C = 8;", "constexpr int C = 4;"))
