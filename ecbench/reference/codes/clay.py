"""Clay, the MSR code of Vajha et al. (FAST'18) in SeaweedFS's shard
files (`ec.encode -kind clay`): every small block one window of alpha
layers.  The configuration states its repair degree d (`repair_degree`);
q = d - k + 1."""

from __future__ import annotations

import numpy as np

from .. import clay, gf256


def _code(config: dict) -> clay.Clay:
    return clay.code(config["data_shards"], config["parity_shards"],
                     config["repair_degree"])


def parity_shards(config: dict, data: np.ndarray) -> np.ndarray:
    code, small = _code(config), config["small_block_size"]
    w_a = small // code.alpha
    out = np.empty((code.m, data.shape[1]), dtype=np.uint8)
    for w0 in range(0, data.shape[1], small):
        window = data[:, w0:w0 + small].reshape(code.k, code.alpha, w_a)
        out[:, w0:w0 + small] = code.encode_window(window).reshape(
            code.m, -1)
    return out


def single_loss_read_bytes(config: dict, lost: int, shard: int) -> int:
    """beta of the alpha layers of each of the d helpers."""
    code = _code(config)
    return code.d * shard * code.beta // code.alpha


def degraded_io_bytes(config: dict, lost: int, length: int) -> int:
    """A degraded read decodes the interval's whole window: k input
    windows and one output."""
    return (config["data_shards"] + 1) * config["small_block_size"]


def control_generator(config: dict) -> np.ndarray:
    """RS(k, m): MDS at the same overhead, not Clay's bytes."""
    return gf256.generator(config["data_shards"], config["parity_shards"])
