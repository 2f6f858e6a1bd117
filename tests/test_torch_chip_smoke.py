"""chip_smoke.py's kernel bounds: the card's memory rate, read from
benchmark/peaks.json by the card's name, and the int32 rate give the
bounds written out by hand below; a card the table lacks gets no
bound."""

import pytest
import torch

import chip_smoke


@pytest.fixture
def card(monkeypatch):
    """Names the card torch.cuda reports."""
    def named(name):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    return named


def test_bound_gives_what_chip_smoke_gave(card):
    card("NVIDIA H100 80GB HBM3")
    assert chip_smoke.hbm_bytes_per_s() == 3.35e12
    assert chip_smoke.INT_OPS_PER_S == 16.75e12
    assert chip_smoke.bound_bytes_ops(6.7e9, 16.75e9) == {
        "bound_ms": pytest.approx(2.0), "bound_by": "bytes"}
    assert chip_smoke.bound_bytes_ops(3.35e9, 33.5e9) == {
        "bound_ms": pytest.approx(2.0), "bound_by": "operations"}
    t = [torch.zeros((512, 65536), dtype=torch.int32),
         torch.zeros(1 << 20, dtype=torch.uint8)]
    # 134,217,728 + 1,048,576 bytes over 3.35 TB/s.
    assert chip_smoke.bound(t, 1000) == {
        "bound_ms": pytest.approx(0.04037800119402985), "bound_by": "bytes"}
    assert chip_smoke.bound(t, 10 ** 9) == {
        "bound_ms": pytest.approx(0.05970149253731343),
        "bound_by": "operations"}


def test_a_card_without_peaks_gets_no_bound(card):
    card("NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match="no memory rate"):
        chip_smoke.bound_bytes_ops(1, 1)
