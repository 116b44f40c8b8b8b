"""The read driver: the seed orders the popularity ranks and draws the
reads, every seed reads the same profile of sizes by rank, and every
answer is compared."""

import json
import os

import numpy as np

from ecbench import harness, volume
from ecbench.drivers import needle_reads
from ecbench.tests.helpers import SEED, SMALL


def _ranked(tmp_path, seed):
    with open(os.path.join(harness.HERE, "configs", "rs10_4.json")) as f:
        c = json.load(f)
    v = volume.make_volume(str(tmp_path / str(seed)), 64 << 20, seed,
                           c["needle_bytes_min"], c["needle_bytes_max"])
    ranked, io = needle_reads.popularity(
        v, {3}, c, np.random.default_rng(seed))
    return v, ranked, io


def test_seeds_read_other_needles_with_the_same_size_profile(tmp_path):
    va, a, io_a = _ranked(tmp_path, 2**40 + 1)
    vb, b, _ = _ranked(tmp_path, 2**40 + 2)
    assert set(io_a) == set(a.tolist()) and len(set(a.tolist())) == len(a)
    assert not np.array_equal(va.offsets[a[:8]], vb.offsets[b[:8]])
    # rank r takes the size at quantile u_r: in the order of u the sizes
    # rise, in both seeds
    for v, ranked in ((va, a), (vb, b)):
        u = np.random.default_rng(needle_reads.RANK_STREAM).random(
            len(ranked))
        assert np.all(np.diff(v.data_sizes[ranked[np.argsort(u)]]) >= 0)
    va2, a2, _ = _ranked(tmp_path, 2**40 + 1)
    assert np.array_equal(a, a2)


def _patch_driver(monkeypatch, **attrs):
    """Load the read driver with `attrs` set; its `run` counts the reads
    of the window in `window["reads"]`."""
    real = harness.load_module
    window = {"reads": None}

    def load(kind, name):
        mod = real(kind, name)
        if kind == "drivers":
            for k, v in attrs.items():
                setattr(mod, k, v)
            real_run = mod.run

            def run(r):
                window["reads"] = 0
                real_run(r)
            mod.run = run
        return mod

    monkeypatch.setattr(harness, "load_module", load)
    return window


def test_every_answer_is_compared(monkeypatch):
    from ecbench.system import Program
    window = _patch_driver(monkeypatch)
    real = Program.read

    def read(vol, nid):
        cookie, got, data = real(vol, nid)
        if window["reads"] is not None:
            window["reads"] += 1
            if window["reads"] == 2:    # one answer of the window
                data = data[:-1] + bytes([data[-1] ^ 1])
        return cookie, got, data

    monkeypatch.setattr(Program, "read", staticmethod(read))
    r = harness.run_cell("rs10_4.degraded_read", SEED, 1.0, False,
                         device="cpu", overrides=SMALL)
    assert r["attempted"] >= 2
    assert r["checks"]["answers_differing"]["value"] == 1
    assert r["correct"] is False


def test_reads_are_drawn_as_the_window_goes(monkeypatch):
    _patch_driver(monkeypatch, BLOCK=1)
    r = harness.run_cell("rs10_4.degraded_read", SEED, 2.0, False,
                         device="cpu", overrides=SMALL)
    assert r["correct"] is True
    assert r["attempted"] >= 3
