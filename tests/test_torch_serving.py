"""The cluster's EC serving path on the port, with no jax in the process.

A subprocess calls `seaweedfs_tpu_torch.serving.install("cpu")` before any
module of the JAX package is imported, then drives the JAX package's own
cluster (SimCluster: a master and 4 volume servers) through the shell's
`ec.encode` / `ec.rebuild` flows, for RS(10,4), Clay(10,4) and
LRC(10,2,2): every RPC reaches erasure coding through the port.  It uploads
seeded blobs, copies the volume's .dat/.idx before the encode, loses shards
1 and 12, reads every blob while they are gone, rebuilds, reads every blob
again, then the same with shard 3 alone; reads every blob with data shard 0
unmounted (a degraded read of each); scrapes a volume server's /metrics;
and reports what it saw.  This process then encodes the copied .dat/.idx
with the JAX package at the same geometry: .ec00-.ec13, .ecx and .vif must
be byte-identical to the cluster's.

Run as a script (`python tests/test_torch_serving.py KIND OUT_DIR`) this
file is that subprocess.
"""

import glob
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
KINDS = {"rs": {}, "clay": {"kind": "clay"},
         "lrc": {"kind": "lrc", "lrc_locals": 2}}
# the single-loss round's plan, as the rebuild RPC's reply reports it
SINGLE_LOSS_PLAN = {"rs": "rs-full", "clay": "clay-plane-fused",
                    "lrc": "local"}
DOUBLE_LOSS_PLAN = {"rs": "rs-full", "clay": "clay-decode", "lrc": "global"}
CODEC_LABEL = {"rs": "rs_torch", "clay": "clay", "lrc": "lrc"}
CODEC_FAMILIES = ("seaweedfs_codec_op_seconds", "seaweedfs_codec_bytes_total",
                  "seaweedfs_codec_dispatch_total",
                  "seaweedfs_codec_dispatch_volumes_total")
FAMILY_FILES = [f".ec{s:02d}" for s in range(14)] + [".ecx", ".vif"]
# a few KiB of blobs: every shard is one 1 MiB small block, so each clay
# window (and each clay degraded read, a [256, 2560] flat decode on the
# CPU) is one
N_BLOBS = 10


# -- the subprocess --------------------------------------------------------

def _holders(c, vid, shard):
    """The volume servers that hold shard `shard` of volume `vid`."""
    return [vs for vs in c.volume_servers
            if any(glob.glob(os.path.join(d.directory, f"{vid}.ec{shard:02d}"))
                   for d in vs.store.locations)]


def _lose(c, env, vid, shards, delete=True):
    """Unmount `shards` (and delete their files) through the volume
    servers' RPCs, as volume.server.evacuate would."""
    for s in shards:
        for vs in _holders(c, vid, s):
            client = env.volume_server(vs.grpc_address)
            client.call("VolumeEcShardsUnmount",
                        {"volume_id": vid, "shard_ids": [s]})
            if delete:
                client.call("VolumeEcShardsDelete",
                            {"volume_id": vid, "collection": "",
                             "shard_ids": [s]})
    c.sync_heartbeats()


def drill(kind: str, out: pathlib.Path) -> dict:
    import torch
    torch.set_num_threads(1)
    from seaweedfs_tpu_torch import serving
    serving.install("cpu")
    import urllib.request

    from seaweedfs_tpu import operation, shell
    from seaweedfs_tpu.shell.command_ec import do_ec_encode, do_ec_rebuild
    from seaweedfs_tpu.testing import SimCluster

    rng = np.random.default_rng(sorted(KINDS).index(kind) + 11)
    res: dict = {"kind": kind}
    with SimCluster(volume_servers=4, base_dir=str(out / "cluster")) as c:
        blobs = {}
        for i in range(N_BLOBS):
            payload = rng.integers(0, 256, 2048 + 17 * i,
                                   dtype=np.uint8).tobytes()
            blobs[operation.assign_and_upload(c.master_grpc, payload)] = \
                payload
        vids = [int(fid.split(",")[0]) for fid in blobs]
        vid = max(set(vids), key=vids.count)
        res["vid"], res["blobs_in_vid"] = vid, vids.count(vid)
        # the volume as the encode will read it: flushed, copied aside
        vol = next(v for v in (vs.store.find_volume(vid)
                               for vs in c.volume_servers) if v is not None)
        vol.sync()
        (out / "orig").mkdir()
        for ext in (".dat", ".idx"):
            shutil.copy(vol.base_path + ext, out / "orig" / f"{vid}{ext}")
        res["version"] = vol.version

        env = shell.CommandEnv(c.master_grpc)
        do_ec_encode(env, vid, **KINDS[kind])
        c.sync_heartbeats()
        (out / "encoded").mkdir()
        for vs in c.volume_servers:
            for d in vs.store.locations:
                for ext in FAMILY_FILES:
                    src = os.path.join(d.directory, f"{vid}{ext}")
                    if os.path.exists(src):
                        shutil.copy(src, out / "encoded" / f"{vid}{ext}")

        def read_all(what):
            bad = [fid for fid, p in blobs.items() if c.read(fid) != p]
            res.setdefault("reads", {})[what] = len(blobs) - len(bad)
            if bad:
                raise AssertionError(f"{what}: blobs {bad} read back wrong")

        read_all("after encode")
        res["rebuilds"] = []
        for lost in ([1, 12], [3]):
            _lose(c, env, vid, lost)
            read_all(f"with {lost} lost")
            out_rb = do_ec_rebuild(env, vid)
            c.sync_heartbeats()
            res["rebuilds"].append({"lost": lost,
                                    "rebuilt": sorted(out_rb["rebuilt"]),
                                    "stats": out_rb["rebuild_stats"]})
            read_all(f"after rebuilding {lost}")
        # data shard 0 holds every blob of this small volume: with it
        # unmounted, each read is reconstructed from the other shards
        holder = _holders(c, vid, 0)[0]
        _lose(c, env, vid, [0], delete=False)
        read_all("with shard 0 unmounted")
        env.volume_server(holder.grpc_address).call(
            "VolumeEcShardsMount", {"volume_id": vid, "collection": "",
                                    "shard_ids": [0]})
        c.sync_heartbeats()
        read_all("after remounting shard 0")
        url = holder.url if holder.url.startswith("http") \
            else f"http://{holder.url}"
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        res["codec_metrics"] = [line for line in text.splitlines()
                                if line.startswith("seaweedfs_codec_")
                                or line.startswith("# TYPE seaweedfs_codec_")]
    res["jax_loaded"] = sorted(m for m in sys.modules
                               if m == "jax" or m.startswith("jax."))
    codec_mod = sys.modules.get("seaweedfs_tpu.ops.codec")
    res["codec_module_is_ports"] = codec_mod is not None and \
        codec_mod.codec_metrics is serving.ops_codec.codec_metrics
    # every module under the reference's codec names is the port's
    res["reference_ec_modules"] = sorted(
        m for m, mod in sys.modules.items()
        if m.startswith(("seaweedfs_tpu.ops", "seaweedfs_tpu.storage.ec"))
        and str(REPO / "seaweedfs_tpu") + os.sep in (
            getattr(mod, "__file__", None) or ""))
    return res


# -- the tests -------------------------------------------------------------

def _run(args, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module", params=sorted(KINDS))
def drilled(request, tmp_path_factory):
    """One drill per code kind, in a subprocess that installed the port."""
    kind = request.param
    out = tmp_path_factory.mktemp(f"drill_{kind}")
    proc = _run([str(pathlib.Path(__file__)), kind, str(out)])
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-8000:]
    with open(out / "result.json") as f:
        return kind, out, json.load(f)


def test_drill_reads_every_blob_back(drilled):
    _, _, res = drilled
    assert res["blobs_in_vid"] >= 2
    assert set(res["reads"].values()) == {N_BLOBS}, res["reads"]
    assert list(res["reads"]) == [
        "after encode", "with [1, 12] lost", "after rebuilding [1, 12]",
        "with [3] lost", "after rebuilding [3]", "with shard 0 unmounted",
        "after remounting shard 0"]


def test_drill_rebuild_plans(drilled):
    kind, _, res = drilled
    (two, one) = res["rebuilds"]
    assert two["rebuilt"] == [1, 12] and one["rebuilt"] == [3]
    assert two["stats"]["plan_kind"] == DOUBLE_LOSS_PLAN[kind]
    assert one["stats"]["plan_kind"] == SINGLE_LOSS_PLAN[kind]
    shard = os.path.getsize(
        pathlib.Path(drilled[1]) / "encoded" / f"{res['vid']}.ec00")
    if kind == "lrc":   # one local group: 5 of the 10 reads RS makes
        assert one["stats"]["read_shards"] == [0, 1, 2, 4, 10]
        assert one["stats"]["bytes_read"] == 5 * shard
    if kind == "clay":  # beta/alpha = 1/4 of each of the 13 helpers
        assert one["stats"]["bytes_read"] == 13 * shard // 4
    if kind == "rs":
        assert one["stats"]["bytes_read"] == 10 * shard


def test_drill_shards_equal_reference_encode(drilled):
    from seaweedfs_tpu.ops.codec import RSCodec as RefCodec
    from seaweedfs_tpu.storage import ec as ref_ec
    kind, out, res = drilled
    vid = res["vid"]
    ref_dir = out / "reference"
    shutil.copytree(out / "orig", ref_dir)
    spec = KINDS[kind]
    geo = ref_ec.EcGeometry(code_kind=spec.get("kind", "rs"),
                            lrc_locals=spec.get("lrc_locals", 0))
    codec = RefCodec(10, 4, backend="numpy") if kind == "rs" else None
    ref_ec.encode_volume_to_ec(str(ref_dir / str(vid)), res["version"], geo,
                               codec)
    for ext in FAMILY_FILES:
        got = (out / "encoded" / f"{vid}{ext}").read_bytes()
        assert got == (ref_dir / f"{vid}{ext}").read_bytes(), ext


def test_drill_metrics_carry_codec_families(drilled):
    kind, _, res = drilled
    text = "\n".join(res["codec_metrics"])
    for fam in CODEC_FAMILIES:
        assert f"# TYPE {fam}" in text
    label = CODEC_LABEL[kind]
    for op in ("encode", "reconstruct"):
        assert f'seaweedfs_codec_dispatch_total{{backend="{label}",' \
               f'op="{op}"}}' in text, (label, op)


def test_drill_loads_no_jax(drilled):
    _, _, res = drilled
    assert res["jax_loaded"] == []
    assert res["codec_module_is_ports"]
    assert res["reference_ec_modules"] == []


_PROBE = ("import sys\n"
          "from seaweedfs_tpu_torch import serving\n")


def test_import_installs_no_alias():
    proc = _run(["-c", _PROBE + "import seaweedfs_tpu_torch.storage.ec\n"
                 "print(sorted(m for m in sys.modules "
                 "if m.split('.')[0] in ('seaweedfs_tpu', 'jax')))"])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_install_refuses_once_reference_is_loaded():
    proc = _run(["-c", "import seaweedfs_tpu.storage.needle\n" + _PROBE
                 + "serving.install('cpu')"])
    assert proc.returncode != 0
    assert "must run before seaweedfs_tpu is imported" in proc.stderr


def test_ec_backend_flag_is_refused():
    proc = _run(["-c", _PROBE + "serving.install('cpu')\n"
                 "from seaweedfs_tpu.command import main\n"
                 "main(['-ec.backend', 'native', 'version'])"])
    assert proc.returncode != 0
    assert "ValueError" in proc.stderr and "no backend pin" in proc.stderr


def test_weed_ec_backend_env_is_refused():
    env = dict(os.environ, WEED_EC_BACKEND="pallas")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c",
                           _PROBE + "serving.install('cpu')"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no backend pin" in proc.stderr


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    out_dir = pathlib.Path(sys.argv[2])
    result = drill(sys.argv[1], out_dir)
    with open(out_dir / "result.json", "w") as f:
        json.dump(result, f)
