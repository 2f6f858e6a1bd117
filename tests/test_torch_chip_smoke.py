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


def test_lzhuf_pack_bound_counts_each_byte_once(card):
    """The LZHUF pack's bound at the lh5.archive cell's shape: a byte, a
    flag and two int32 a position, the joint table, the header slots
    (1,058 at lh5) and the row offsets read once; the words written
    once."""
    from tpz_torch.kernels.lzhuf_plan_device import Plan

    card("NVIDIA H100 80GB HBM3")
    nb, b, s, words = 1024, 32768, 1058, 3_000_000

    tok = torch.empty((nb, b), dtype=torch.bool)
    ml = torch.empty((nb, b), dtype=torch.int32)
    md = torch.empty((nb, b), dtype=torch.int32)
    table = torch.empty((nb, 530), dtype=torch.int32)
    plan = Plan(*(None,) * 4, torch.empty((nb, s), dtype=torch.int64),
                torch.empty((nb, s), dtype=torch.int32),
                torch.empty(nb, dtype=torch.int64),
                torch.empty(nb, dtype=torch.int64), None, None)
    out = torch.empty(words, dtype=torch.int32)
    got = chip_smoke.lzhuf_pack_bound(tok, ml, md, table, plan, out)
    nbytes = (nb * b * (1 + 1 + 4 + 4) + nb * 530 * 4 + nb * s * (8 + 4)
              + nb * 16 + words * 4)
    assert got == {"bound_ms": pytest.approx(nbytes / 3.35e12 * 1e3),
                   "bound_by": "bytes"}
    assert 0.10 < got["bound_ms"] < 0.12
