"""The check fails a run whose timed path is broken underneath: each fault
planted in the program's codec calls (device_call_begin, which every RS
product and both fused Clay kernels go through, and gf_apply, Clay's
degraded decode), in every cell, on the CPU at a small size.  A run on
one card has no exchange between chips to leave out."""

import numpy as np
import pytest

from ecbench.tests.helpers import CELLS, run_small


def _altered(out):          # an answer altered where it is produced
    out.reshape(-1)[0] ^= 1


def _half(out):             # half of the batch's columns left out
    out[..., out.shape[-1] // 2:] = 0


def _unchanged(out):        # the step leaves its output as it was
    out[...] = 0


FAULTS = {"altered": _altered, "half_batch": _half, "unchanged": _unchanged}


def _plant(monkeypatch, fault):
    from seaweedfs_tpu_torch.ops import codec
    from seaweedfs_tpu_torch.storage.ec import codes, ec_volume
    real_call, real_apply = codec.device_call_begin, codec.gf_apply

    def device_call_begin(device, stream, inputs, fn):
        fetch = real_call(device, stream, inputs, fn)

        def broken():
            out = np.array(fetch())
            fault(out)
            return out
        return broken

    def gf_apply(M, x, *, device=None):
        out = np.array(real_apply(M, x, device=device))
        fault(out)
        return out

    for mod in (codec, codes):
        monkeypatch.setattr(mod, "device_call_begin", device_call_begin)
    for mod in (codec, codes, ec_volume):
        monkeypatch.setattr(mod, "gf_apply", gf_apply)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    _plant(monkeypatch, FAULTS[fault])
    r = run_small(cell)
    assert r["correct"] is False
    assert r["failed"] > 0 or any(
        c["value"] > c["limit"] for c in r["checks"].values())
