"""The port's arrival processes (``repro_torch.core.traffic``) against
``repro.core.traffic``: from the same seeds every sample, rate, trace and
error is the reference's (``==``).  Mirrors tests/test_traffic.py class
by class."""

import json

import numpy as np
import pytest

from repro.core import traffic as jt
from repro_torch.core import traffic as pt


def _processes(tr):
    return [
        tr.PoissonProcess(2.0),
        tr.DiurnalPoisson(2.0, amplitude=0.8, period=10.0),
        tr.FlashCrowd(0.5, 4.0, start=3.0, duration=2.0),
        tr.InhomogeneousPoisson(lambda t: 1.0 + 0.5 * np.cos(np.asarray(t)),
                                rate_max=1.5),
        tr.TraceArrivals([0.5, 1.5, 2.5, 9.9]),
    ]


PAIRS = list(zip(_processes(jt), _processes(pt)))
IDS = [type(p).__name__ for p, _ in PAIRS]


def _both(fn):
    """``fn(module)`` on the reference and the port."""
    return fn(jt), fn(pt)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
class TestSampleContract:
    def test_sorted_float64_in_window_equal(self, pair):
        ref, got = (p.sample(np.random.default_rng(0), 0.0, 10.0)
                    for p in pair)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, ref)
        assert np.all(np.diff(got) >= 0)
        assert got.size == 0 or (got[0] >= 0.0 and got[-1] < 10.0)

    def test_seed_determinism(self, pair):
        _, proc = pair
        a = proc.sample(np.random.default_rng(42), 0.0, 10.0)
        b = proc.sample(np.random.default_rng(42), 0.0, 10.0)
        np.testing.assert_array_equal(a, b)

    def test_empty_window(self, pair):
        assert pair[1].sample(np.random.default_rng(0), 3.0, 3.0).size == 0

    def test_bad_window_raises(self, pair):
        for proc in pair:
            with pytest.raises(ValueError):
                proc.sample(np.random.default_rng(0), 5.0, 4.0)
            with pytest.raises(ValueError):
                proc.mean_rate(0.0, float("inf"))

    def test_mean_rate_equal(self, pair):
        ref, got = (p.mean_rate(0.0, 10.0) for p in pair)
        assert got == ref


class TestPoisson:
    @pytest.mark.parametrize("rate", [-1.0, float("nan")])
    def test_rejects_bad_rate(self, rate):
        with pytest.raises(ValueError):
            pt.PoissonProcess(rate)

    def test_empirical_rate_equal(self):
        ref, got = _both(lambda m: m.PoissonProcess(3.0).sample(
            np.random.default_rng(1), 0.0, 10_000.0))
        np.testing.assert_array_equal(got, ref)
        assert got.size == pytest.approx(30_000, rel=0.02)
        assert pt.PoissonProcess(3.0).mean_rate(0.0, 5.0) == 3.0


class TestInhomogeneous:
    def test_diurnal_samples_equal(self):
        ref, got = _both(lambda m: m.DiurnalPoisson(
            5.0, amplitude=1.0, period=8.0).sample(
                np.random.default_rng(7), 0.0, 4_000.0))
        np.testing.assert_array_equal(got, ref)
        assert got.size == pytest.approx(20_000, rel=0.03)
        ref, got = _both(lambda m: m.DiurnalPoisson(
            5.0, amplitude=1.0, period=8.0).mean_rate(0.0, 8.0))
        assert got == ref == pytest.approx(5.0, rel=1e-3)

    def test_flash_crowd_equal_and_surges(self):
        ref, got = _both(lambda m: m.FlashCrowd(
            0.5, 20.0, start=100.0, duration=10.0).sample(
                np.random.default_rng(11), 0.0, 200.0))
        np.testing.assert_array_equal(got, ref)
        in_surge = ((got >= 100.0) & (got < 110.0)).sum()
        assert in_surge == pytest.approx(200, rel=0.25)

    @pytest.mark.parametrize("level", [5.0, -1.0])
    def test_rate_outside_envelope_raises(self, level):
        for m in (jt, pt):
            proc = m.InhomogeneousPoisson(
                lambda t: np.full(np.shape(t), level), rate_max=1.0)
            with pytest.raises(ValueError):
                proc.sample(np.random.default_rng(0), 0.0, 100.0)

    @pytest.mark.parametrize("make", [
        lambda m: m.DiurnalPoisson(1.0, amplitude=1.5),
        lambda m: m.FlashCrowd(2.0, 1.0, start=0.0, duration=1.0),
        lambda m: m.InhomogeneousPoisson(lambda t: t, rate_max=0.0),
    ])
    def test_rejects_bad_params(self, make):
        for m in (jt, pt):
            with pytest.raises(ValueError):
                make(m)


class TestTrace:
    def test_chunking_is_exact(self):
        tr = pt.TraceArrivals([3.0, 0.5, 7.2, 5.0, 5.0 + 1e-12])
        rng = np.random.default_rng(0)
        whole = tr.sample(rng, 0.0, 10.0)
        chunks = np.concatenate([tr.sample(rng, a, b) for a, b in
                                 [(0.0, 2.5), (2.5, 5.0), (5.0, 10.0)]])
        np.testing.assert_array_equal(whole, chunks)
        assert whole.size == 5

    def test_window_is_half_open(self):
        tr = pt.TraceArrivals([1.0, 2.0, 3.0])
        assert tr.sample(np.random.default_rng(0), 1.0,
                         3.0).tolist() == [1.0, 2.0]

    @pytest.mark.parametrize("times", [[1.0, float("nan")], [[1.0, 2.0]]])
    def test_rejects_bad_traces(self, times):
        with pytest.raises(ValueError):
            pt.TraceArrivals(times)


class TestLoadTrace:
    def test_csv_roundtrip_equal(self, tmp_path):
        p = tmp_path / "trace.csv"
        p.write_text("cell,arrival,extra\n0,1.5,x\n1,9.0,y\n0,0.25,z\n")
        for cell in (0, 1, 2):
            ref, got = _both(lambda m: m.load_trace(p, cell=cell).times)
            np.testing.assert_array_equal(got, ref)
        assert pt.load_trace(p, cell=0).times.tolist() == [0.25, 1.5]

    @pytest.mark.parametrize("suffix,text,cell,match", [
        (".csv", "time\n1.5\n", 0, "'cell' and 'arrival'"),
        (".csv", "cell,arrival\n0,1.5\n0,oops\n", 0, "row 3.*not a number"),
        (".csv", "cell,arrival\n0,\n", 0, "row 2.*missing"),
        (".csv", "cell,arrival\nzero,1.5\n", 0, "not an integer"),
        (".csv", "cell,arrival\n0,-2.0\n", 0, "finite and >= 0"),
        (".json", "not json {", 0, "not valid JSON"),
        (".json", json.dumps([1.0, "x"]), 0, "entry 1.*not a number"),
        (".json", json.dumps([1.0]), 2, "cell=2"),
        (".json", json.dumps({"0": [1.0]}), 5, "no trace for cell 5"),
        (".json", json.dumps({"0": 17}), 0, "list of timestamps"),
        (".json", json.dumps(42), 0, "list of times"),
    ])
    def test_malformed_files_raise_alike(self, tmp_path, suffix, text, cell,
                                         match):
        p = tmp_path / f"trace{suffix}"
        p.write_text(text)
        msgs = []
        for m in (jt, pt):
            with pytest.raises(ValueError, match=match) as err:
                m.load_trace(p, cell=cell)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]

    def test_json_flat_and_keyed(self, tmp_path):
        p = tmp_path / "trace.json"
        p.write_text(json.dumps([2.0, 1.0]))
        assert pt.load_trace(p).times.tolist() == [1.0, 2.0]
        p.write_text(json.dumps({"0": [1.0], "3": [4.0, 2.0]}))
        assert pt.load_trace(p, cell=3).times.tolist() == [2.0, 4.0]


class TestCorrelatedRates:
    @pytest.mark.parametrize("correlation", [0.0, 0.5, 1.0])
    def test_rates_equal(self, correlation):
        ref, got = _both(lambda m: m.correlated_rates(
            np.random.default_rng(5), 16, 2.0, correlation=correlation))
        np.testing.assert_array_equal(got, ref)
        assert np.all(got > 0)
        if correlation == 1.0:
            assert np.ptp(got) == pytest.approx(0.0, abs=1e-12)

    def test_mean_and_positivity(self):
        rates = np.concatenate([
            pt.correlated_rates(np.random.default_rng(s), 64, 2.0,
                                correlation=0.5)
            for s in range(200)])
        assert rates.mean() == pytest.approx(2.0, rel=0.02)

    @pytest.mark.parametrize("n,corr", [(4, 1.5), (0, 0.5)])
    def test_rejects_bad_params(self, n, corr):
        with pytest.raises(ValueError):
            pt.correlated_rates(np.random.default_rng(0), n, 1.0,
                                correlation=corr)
