"""tpz_torch/utils/roofline.py against the reference's
tpz/utils/roofline.py: the same model names and annotation keys, the
kernel bounds chip_smoke.py prices with (values written out by hand), no
roofline for a card without peaks, rates measured on the CPU, and the
models' layouts equal to what the pipelines lay out."""

import math

import numpy as np
import pytest
import torch

from tpz.utils import roofline as jroofline
from tpz_torch.kernels import deflate_pipeline as dp
from tpz_torch.kernels import lzhuf_pipeline
from tpz_torch.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"
# Rates as measure_rates gives them, written in by hand.
RATES = {"sort_keys_per_s": 2e9, "sort3_keys_per_s": 1e9,
         "cumsum_elems_per_s": 2e10, "gather_elems_per_s": 1e10,
         "elementwise_bytes_per_s": 2e12, "launch_round_trip_s": 2e-5}


def test_models_have_the_references_names():
    assert list(roofline.MODELS) == list(jroofline.MODELS)


@pytest.mark.parametrize("name", list(jroofline.MODELS))
def test_annotate_gives_the_references_keys(name):
    nbytes = 4 << 20
    got = roofline.annotate(name, nbytes, 50.0, rates=RATES, card=H100)
    want = jroofline.annotate(name, nbytes, 50.0)
    assert set(got) == set(want)
    assert set(got["dominant_terms"]) <= set(roofline.MODELS[name](nbytes))
    assert len(got["dominant_terms"]) == 2
    assert 0 < got["pct_of_kernel"] < got["pct_of_achievable"]
    assert roofline.annotate(name, nbytes, 0.0, rates=RATES,
                             card=H100) is None


def test_annotate_prices_the_work():
    """One model priced by hand: 1 MiB of lh5 decode."""
    n = 1 << 20
    work = roofline.lzhuf_decode_model(n)
    secs = (work["kernel_ops_count"] / (67e12 / 4)
            + 16 * n / RATES["elementwise_bytes_per_s"])
    got = roofline.annotate("lzhuf_decode_device", n, 10.0, rates=RATES,
                            card=H100)
    assert got["kernel_achievable_MB_s"] == pytest.approx(n / secs / 1e6)
    assert got["achievable_MB_s"] == pytest.approx(
        n / (secs + RATES["launch_round_trip_s"]) / 1e6)


def test_bound_gives_what_chip_smoke_gave():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.INT_OPS_PER_S == 16.75e12
    assert roofline.bound_bytes_ops(6.7e9, 16.75e9) == {
        "bound_ms": pytest.approx(2.0), "bound_by": "bytes"}
    assert roofline.bound_bytes_ops(3.35e9, 33.5e9) == {
        "bound_ms": pytest.approx(2.0), "bound_by": "operations"}
    t = [torch.zeros((512, 65536), dtype=torch.int32),
         torch.zeros(1 << 20, dtype=torch.uint8)]
    # 134,217,728 + 1,048,576 bytes over 3.35 TB/s.
    assert roofline.bound(t, 1000) == {
        "bound_ms": pytest.approx(0.04037800119402985), "bound_by": "bytes"}
    assert roofline.bound(t, 10 ** 9) == {
        "bound_ms": pytest.approx(0.05970149253731343),
        "bound_by": "operations"}


def test_a_card_without_peaks_gets_no_roofline():
    card = "NVIDIA A100-SXM4-80GB"
    assert roofline.peaks(card) is None
    assert roofline.peaks(H100) == {"hbm_bytes_per_s": 3.35e12,
                                    "int_ops_per_s": 16.75e12}
    assert roofline.annotate("deflate_encode_device", 1 << 20, 50.0,
                             rates=RATES, card=card) is None


def test_measure_rates_on_the_cpu():
    rates = roofline.measure_rates("cpu", rows=2, m=4096, reps=2)
    assert set(rates) == set(RATES)
    assert all(math.isfinite(v) and v > 0 for v in rates.values())
    assert roofline.measure_rates("cpu", rows=2, m=4096, reps=2) == rates


@pytest.mark.parametrize("sizes", [[1], [65536], [65537], [70000, 70000],
                                   [66667, 66667, 66666],
                                   [16 << 20, 16 << 20]])
def test_deflate_layout_equals_the_pipelines(sizes):
    datas = [bytes(n) for n in sizes]
    span, _, _, block_len, *_ = dp.span_layout(datas)
    nb, m = roofline.deflate_layout(sum(sizes), len(sizes))
    assert nb == len(block_len)
    if sum(sizes) < 1 << 20:
        assert dp._make_words(torch.from_numpy(span)).shape == (nb, m)
    work = roofline.deflate_encode_model(sum(sizes), len(sizes))
    assert work["sort3_keys_count"] == nb * m
    assert work["cumsum_elems_count"] == nb * dp.BLOCK


@pytest.mark.parametrize("method", ["lh5", "lh7"])
@pytest.mark.parametrize("sizes", [[1], [32768], [40000, 40000]])
def test_lzhuf_layout_equals_the_pipelines(sizes, method):
    window = 1 << lzhuf_pipeline.C.LZHUF_METHODS[method][0]
    blocks, *_ = lzhuf_pipeline.make_blocks(
        [np.zeros(n, np.uint8).tobytes() for n in sizes], window, "cpu")
    assert tuple(blocks.shape) == roofline.lzhuf_layout(
        sum(sizes), len(sizes), method)
