"""The system under test: seaweedfs_tpu_torch through its serving binding.

`serving.bind(device)` is the surface the volume server's EC RPCs call:
encode_volume_to_ec for VolumeEcShardsGenerate, rebuild_ec_files for
VolumeEcShardsRebuild, and EcVolume(dir, collection, vid) + load_shard +
read_needle for the store's EC reads.  The benchmark takes from the
program only these calls, the codec metrics' text page and the kernel
names in the device trace.
"""

from __future__ import annotations

import dataclasses
import os
import re


class Program:
    def __init__(self, device, config: dict):
        from seaweedfs_tpu_torch import serving
        from seaweedfs_tpu_torch.storage.ec.layout import EcGeometry
        self.ec = serving.bind(device)
        # the configuration's keys that name a field of the geometry
        self.geo = EcGeometry(**{
            f.name: config[f.name] for f in dataclasses.fields(EcGeometry)
            if f.name in config})

    @staticmethod
    def cache_dirs() -> list:
        """The directories the program builds its kernels into."""
        from seaweedfs_tpu_torch.ops import _build
        return [_build.BUILD_DIR]

    def encode(self, base: str) -> None:
        self.ec.encode_volume_to_ec(base, version=3, geo=self.geo)

    def rebuild(self, base: str) -> dict:
        """Restore every missing shard; returns the rebuild's read
        accounting."""
        stats: dict = {}
        self.ec.rebuild_ec_files(base, stats=stats)
        return stats

    def open_volume(self, directory: str, vid: int, shards: list):
        vol = self.ec.EcVolume(directory, "", vid)
        for s in shards:
            vol.load_shard(s)
        return vol

    @staticmethod
    def read(vol, nid: int) -> tuple[int, int, bytes]:
        """(cookie, id, payload) of the needle the store serves."""
        n = vol.read_needle(nid)
        return n.cookie, n.id, bytes(n.data)

    @staticmethod
    def close_volume(vol) -> None:
        vol.close()

    @staticmethod
    def counters() -> dict:
        """{(sample name, backend, op): value} of the codec metrics' text
        page, as GET /metrics shows it."""
        from seaweedfs_tpu_torch.ops.codec import codec_metrics
        return parse_metrics(codec_metrics().registry.render())


_SAMPLE = re.compile(
    r'^(\w+)\{backend="([^"]*)",op="([^"]*)"\}\s+(\S+)$')


def parse_metrics(page: str) -> dict:
    out = {}
    for line in page.splitlines():
        m = _SAMPLE.match(line)
        if m:
            out[m.group(1), m.group(2), m.group(3)] = float(m.group(4))
    return out
