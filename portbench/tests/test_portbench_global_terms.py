"""The reader of the far-edge and degree-term kernel's device time a draw."""

import importlib.util
from pathlib import Path

READER = (Path(__file__).resolve().parents[1] / "metrics"
          / "global_terms_ms_per_draw.global.py")


def _read(ctx):
    spec = importlib.util.spec_from_file_location("global_terms_ms", READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def test_reader_sums_its_kernel_over_the_draws():
    trace = {"steps": 4, "kernels": {
        "void (anonymous namespace)::global_terms_kernel<2, true>(Args)":
            [1.0e-4, 2.0e-4, 1.5e-4, 1.5e-4],
        "void band_cross_float_kernel<2, 6>(Args)": [7.0e-4] * 4}}
    assert abs(_read({"trace": trace}) - 0.15) < 1e-12


def test_reader_finds_nothing_where_the_kernel_did_not_run():
    assert _read({"trace": None}) is None
    assert _read({}) is None
    other = {"steps": 24, "kernels": {
        "void band_cross_float_kernel<2, 6>(Args)": [7.0e-4],
        "void at::native::vectorized_elementwise_kernel<4>(...)": [1e-4]}}
    assert _read({"trace": other}) is None
    assert _read({"trace": {"steps": 0, "kernels": {
        "global_terms_kernel<4, false>": [1e-4]}}}) is None
