"""What the benchmark needs of each code kind, one module per kind
(`codes/<code_kind>.py`), found by the configuration's `code_kind`: a
configuration of a new kind adds its module and no other code.

A kind's module has, each taking the configuration first:

    parity_shards(config, data)       [m, size] parity of the [k, size]
                                      data shards, in SeaweedFS's layout
    single_loss_read_bytes(config, lost, shard)
                                      bytes a rebuild of shard `lost`
                                      alone reads, of shards of `shard`
                                      bytes each
    degraded_io_bytes(config, lost, length)
                                      the codec's least traffic to decode
                                      `length` bytes of shard `lost`
    control_generator(config)         [k+m, k] generator of another MDS
                                      code at the same overhead, the one
                                      the control (control/system.py) uses
"""

from __future__ import annotations

import importlib


def of(config: dict):
    """The module of the configuration's code kind."""
    kind = config["code_kind"]
    name = f"{__name__}.{kind}"
    if not kind.isidentifier():
        raise ValueError(f"no reference for code kind {kind!r}")
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no reference for code kind {kind!r}") from None
