"""What depends on the code kind sits in one module per kind
(reference/codes/<kind>.py), found by the configuration's code_kind; the
drivers, the control and the program's geometry take it from there."""

import json
import os

import numpy as np
import pytest

from ecbench import harness
from ecbench.reference import clay, codes

HOOKS = ("parity_shards", "single_loss_read_bytes", "degraded_io_bytes",
         "control_generator")


def _config(name):
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["rs10_4", "clay10_4"])
def test_each_configuration_finds_its_kind(name):
    c = _config(name)
    mod = codes.of(c)
    assert mod.__name__.endswith("." + c["code_kind"])
    for hook in HOOKS:
        assert callable(getattr(mod, hook))
    gen = mod.control_generator(c)
    k, m = c["data_shards"], c["parity_shards"]
    assert gen.shape == (k + m, k)
    assert np.array_equal(gen[:k], np.eye(k, dtype=np.uint8))


@pytest.mark.parametrize("kind", ["lrc", "no-such", "os"])
def test_a_kind_without_a_module_is_refused(kind):
    with pytest.raises(ValueError, match="no reference for code kind"):
        codes.of({"code_kind": kind})


def test_clay_read_plan_follows_q():
    c = _config("clay10_4")
    code = clay.code(10, 4, 13)
    assert (code.q, code.beta, code.alpha) == (4, 64, 256)
    shard = 7 << 20
    got = codes.of(c).single_loss_read_bytes(c, 0, shard)
    assert got == 13 * shard * 64 // 256 == 13 * shard // 4
    assert codes.of(c).degraded_io_bytes(c, 3, 100) == 11 * (1 << 20)


def test_clay_refuses_a_degree_it_cannot_build():
    with pytest.raises(ValueError, match="d = n - 1"):
        clay.code(10, 4, 12)
    with pytest.raises(ValueError, match="d = n - 1"):
        codes.of(_config("clay10_4")).single_loss_read_bytes(
            {**_config("clay10_4"), "repair_degree": 11}, 0, 1 << 20)


def test_rs_read_plan():
    c = _config("rs10_4")
    assert codes.of(c).single_loss_read_bytes(c, 13, 5) == 50
    assert codes.of(c).degraded_io_bytes(c, 3, 100) == 1100


def test_program_geometry_takes_every_field_the_configuration_names():
    from ecbench.system import Program
    c = _config("clay10_4")
    geo = Program("cpu", {**c, "lrc_locals": 0}).geo
    assert (geo.data_shards, geo.parity_shards, geo.code_kind,
            geo.small_block_size, geo.large_block_size) == (
                10, 4, "clay", c["small_block_size"], c["large_block_size"])
    geo = Program("cpu", {**_config("rs10_4"), "code_kind": "lrc",
                          "lrc_locals": 2}).geo
    assert (geo.code_kind, geo.lrc_locals) == ("lrc", 2)
