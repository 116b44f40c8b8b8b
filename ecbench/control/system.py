"""The control: the plain reference put in the program's place, with one
guarantee of the configuration broken in the operation the cell measures.
A benchmark whose check cannot fail it could not fail the program either.

- encode jobs: parity from another MDS code at the same overhead, the
  code kind's `control_generator` (reference/codes/: RS with klauspost's
  Cauchy matrix for RS; plain RS(10,4) for Clay): any 4 losses stay
  recoverable, the shards are not SeaweedFS's.
- rebuild jobs: the RS rebuild, k whole survivors read and decoded with
  RS's matrix (Cauchy's for an RS volume): for Clay it reads 40/40 of RS's
  bytes, not 13/40, and restores other bytes.
- needle reads: the lost interval decoded from the same byte range of k
  survivors with the other code's matrix.

Set-up work of other kinds (the encode before a rebuild or read cell) is
the reference done right.  Nothing here imports the program.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from ecbench.reference import codes, gf256, layout, needle


class Control:
    def __init__(self, config: dict, traffic: dict):
        self.c = config
        self.k, self.m = config["data_shards"], config["parity_shards"]
        self.small = config["small_block_size"]
        self.broken = traffic["driver"]
        self.code = codes.of(config)
        self.wrong_gen = self.code.control_generator(config)

    def encode(self, base: str) -> None:
        dat = np.fromfile(base + ".dat", dtype=np.uint8)
        data = layout.data_shards(dat, self.k, self.small,
                                  self.c["large_block_size"])
        if self.broken == "encode_jobs":
            parity = gf256.matmul_rows(self.wrong_gen[self.k:], data)
        else:
            parity = self.code.parity_shards(self.c, data)
        for s, row in enumerate(np.concatenate([data, parity])):
            row.tofile(f"{base}.ec{s:02d}")
        with open(base + ".idx", "rb") as f:
            keys, offsets, sizes = needle.parse_index(f.read())
        order = np.argsort(keys, kind="stable")
        with open(base + ".ecx", "wb") as f:
            f.write(needle.index_bytes(keys[order], offsets[order],
                                       sizes[order]))
        with open(base + ".vif", "w") as f:
            json.dump({"version": 3, "dat_size": len(dat)}, f)

    def rebuild(self, base: str) -> dict:
        n = self.k + self.m
        have = [s for s in range(n) if os.path.exists(f"{base}.ec{s:02d}")]
        missing = [s for s in range(n) if s not in have]
        chosen = have[:self.k]
        x = np.stack([np.fromfile(f"{base}.ec{s:02d}", dtype=np.uint8)
                      for s in chosen])
        D = gf256.decode_matrix(self.wrong_gen, chosen, missing)
        for s, row in zip(missing, gf256.matmul_rows(D, x)):
            row.tofile(f"{base}.ec{s:02d}")
        return {"bytes_read": int(x.size), "plan_kind": "control-full-read"}

    def open_volume(self, directory: str, vid: int, shards: list):
        base = os.path.join(directory, str(vid))
        with open(base + ".ecx", "rb") as f:
            keys, offsets, sizes = needle.parse_index(f.read())
        return {"base": base, "shards": sorted(shards),
                "index": {int(key): (int(o), int(s))
                          for key, o, s in zip(keys, offsets, sizes)}}

    def read(self, vol: dict, nid: int) -> tuple[int, int, bytes]:
        offset, body = vol["index"][nid]
        parts = []
        for shard, at, ln in layout.locate(
                offset, needle.record_size(body - 5), self.k, self.small):
            if shard in vol["shards"]:
                parts.append(self._pread(vol, shard, at, ln))
                continue
            chosen = vol["shards"][:self.k]
            x = np.stack([np.frombuffer(self._pread(vol, s, at, ln),
                                        np.uint8) for s in chosen])
            D = gf256.decode_matrix(self.wrong_gen, chosen, [shard])
            parts.append(gf256.matmul_rows(D, x)[0].tobytes())
        rec = b"".join(parts)
        cookie, got_id = struct.unpack_from(">IQ", rec)
        lo = needle.HEADER + 4
        return cookie, got_id, rec[lo:lo + body - 5]

    @staticmethod
    def _pread(vol: dict, shard: int, at: int, ln: int) -> bytes:
        with open(f"{vol['base']}.ec{shard:02d}", "rb") as f:
            return os.pread(f.fileno(), ln, at)

    @staticmethod
    def close_volume(vol) -> None:
        pass

    @staticmethod
    def counters() -> dict:
        return {}

    @staticmethod
    def cache_dirs() -> list:
        return []
