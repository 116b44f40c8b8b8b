"""The cluster's EC serving path on the port.

The JAX package's volume server, store, shell and master reach erasure
coding only through `seaweedfs_tpu.storage.ec` (the package and six
submodules) and `seaweedfs_tpu.ops.codec` (the codec metrics that GET
/metrics appends, and the `-ec.backend` pin).  `install(device)` puts this
package's modules under those names before any module of that package is
imported.  Its daemons then run the EC RPCs (VolumeEcShardsGenerate /
Rebuild / ToVolume), the EC volumes the store mounts, their degraded reads
and /metrics on this package, with every codec on `device`, and never load
jax:

    from seaweedfs_tpu_torch import serving
    serving.install("cuda")
    from seaweedfs_tpu.command import main
    main(["volume", "-dir", "/data", "-mserver", "localhost:9333"])

The RPCs name no device and this package's entry points raise without
CUDA, so the device is the caller's: "cuda" on a GPU host, "cpu" (the
kernels' plain versions) only where a caller asks for it, or a
`parallel.mesh.Mesh` (e.g. `parallel.mesh_codec.default_ec_mesh()` over
every GPU): encodes and rebuilds then run on the mesh (MeshCodec for RS,
the window codecs' mesh arms for Clay and LRC), and EC volumes read on its
first position.  There is no backend pin: the bound
`validate_ec_backend_pin` refuses `-ec.backend`.

Importing this module installs nothing.  `bind(device)` returns the bound
surface without touching `sys.modules`.
"""

from __future__ import annotations

import os
import sys
import types

from .ops import codec as ops_codec
from .storage import ec
from .storage.ec import (codes, decoder, ec_volume, encoder, layout,
                         shard_bits)

REFERENCE = "seaweedfs_tpu"
EC_MODULE = REFERENCE + ".storage.ec"
CODEC_MODULE = REFERENCE + ".ops.codec"
# the port's modules as they are: none of them builds a codec
PLAIN_SUBMODULES = {"codes": codes, "decoder": decoder, "layout": layout,
                    "shard_bits": shard_bits}


def _module(name: str, source: types.ModuleType,
            **overrides) -> types.ModuleType:
    """A module named `name` that holds `source`'s names with `overrides`
    in place.  Functions keep their own globals, so only the overridden
    entry points change; no package path is copied, so a submodule that is
    not bound cannot be imported under `name`."""
    mod = types.ModuleType(name, source.__doc__)
    mod.__dict__.update({k: v for k, v in vars(source).items()
                         if not k.startswith("__")})
    mod.__dict__.update(overrides)
    return mod


def bind(device) -> types.ModuleType:
    """The storage-EC surface the JAX package's serving code calls, every
    codec built on `device` (a torch device or a Mesh):
    `encode_volume_to_ec(base, version=, geo=)`, `rebuild_ec_files(base,
    stats=)`, `decode_ec_to_volume(base)` and `EcVolume(dir, collection,
    vid)` build their codec for the volume's geometry there when the
    caller passes none (EcVolume on a mesh's first position: its degraded
    reads stay on one device); everything else is this package's
    `storage.ec` as it is.  The submodules are attributes: `ec_volume` and
    `encoder` bound the same way, the others plain."""
    mesh, one = codes.placement(device)
    dev = mesh or one

    # the entry's job opens here, where its codec is built, so that it
    # holds the build (the storage calls' own jobs open only for
    # callers outside a job)
    def encode_volume_to_ec(base_path, version, geo=layout.DEFAULT_GEOMETRY,
                            codec=None):
        with ops_codec.job("ec.encode_volume", os.path.basename(base_path)):
            ec.encode_volume_to_ec(
                base_path, version, geo,
                codec or encoder.codec_for(geo, device=dev))

    def rebuild_ec_files(base_path, geo=None, codec=None,
                         batch_bytes=encoder.DEFAULT_BATCH_BYTES,
                         stats=None):
        with ops_codec.job("ec.rebuild", os.path.basename(base_path)):
            geo = geo or ec.geometry_from_vif(base_path)
            return ec.rebuild_ec_files(
                base_path, geo, codec or encoder.codec_for(geo, device=dev),
                batch_bytes, stats)

    def decode_ec_to_volume(base_path, geo=None, codec=None):
        geo = geo or ec.geometry_from_vif(base_path)
        ec.decode_ec_to_volume(
            base_path, geo, codec or encoder.codec_for(geo, device=dev))

    class EcVolume(ec_volume.EcVolume):
        def __init__(self, directory, collection, vid, geo=None, codec=None,
                     **kwargs):
            geo = geo or ec.geometry_from_vif(
                ec_volume.volume_base(directory, collection, vid))
            super().__init__(directory, collection, vid, geo,
                             codec or encoder.codec_for(geo, device=one),
                             **kwargs)

    bound_volume = _module(EC_MODULE + ".ec_volume", ec_volume,
                           EcVolume=EcVolume)
    bound_encoder = _module(EC_MODULE + ".encoder", encoder,
                            rebuild_ec_files=rebuild_ec_files)
    return _module(EC_MODULE, ec, device=dev,
                   encode_volume_to_ec=encode_volume_to_ec,
                   rebuild_ec_files=rebuild_ec_files,
                   decode_ec_to_volume=decode_ec_to_volume,
                   EcVolume=EcVolume, ec_volume=bound_volume,
                   encoder=bound_encoder, **PLAIN_SUBMODULES)


def _no_backend_pin(*_args, **_kwargs):
    raise ValueError(
        "-ec.backend / WEED_EC_BACKEND: seaweedfs_tpu_torch has no backend "
        "pin; its codecs run on the device serving.install() was given")


def install(device) -> types.ModuleType:
    """Put `bind(device)` and its submodules in `sys.modules` under the
    `seaweedfs_tpu.storage.ec*` names, and this package's codec module,
    whose backend pin refuses, under `seaweedfs_tpu.ops.codec`.  Returns the
    bound package.  Raises when a module of the JAX package is already
    loaded (it may hold the modules these names stand for) and when
    WEED_EC_BACKEND asks for a backend."""
    loaded = sorted(m for m in sys.modules
                    if m == REFERENCE or m.startswith(REFERENCE + "."))
    if loaded:
        raise RuntimeError(
            f"serving.install() must run before {REFERENCE} is imported; "
            f"already loaded: {', '.join(loaded[:5])}")
    if os.environ.get("WEED_EC_BACKEND", "").strip().lower() not in (
            "", "auto"):
        _no_backend_pin()
    surface = bind(device)
    sys.modules[EC_MODULE] = surface
    for sub in ("ec_volume", "encoder", *PLAIN_SUBMODULES):
        sys.modules[f"{EC_MODULE}.{sub}"] = getattr(surface, sub)
    sys.modules[CODEC_MODULE] = _module(
        CODEC_MODULE, ops_codec, validate_ec_backend_pin=_no_backend_pin,
        reset_backend_probe=_no_backend_pin)
    return surface
