"""The FSDP axis of the port (`pcm_tpu_torch/parallel/fsdp.py`, the layout of
`parallel/mesh.py`) and its dry run (`pcm_tpu_torch/dryrun.py`) on the CPU.

- The plan against JAX's `fsdp_sharding` on a ``make_mesh(data=4,
  fsdp=2)`` mesh (the conftest's 8 CPU devices), on the TINY SD1.5, SDXL and
  SD3 frozen trees, float and int8, leaves matched by the converters'
  diffusers names: a leaf is split iff JAX splits it, over an axis of the
  same length (the layouts are each other's transposes).
- The layout's coordinates against JAX's device grid.
- Shard -> gather in one process, two ranks simulated by swapping the
  all-gather for a concatenation of both copies' buffers: every leaf comes
  back bit for bit with its strides (channels-last convs, int8 codes), the
  forwards equal the unsharded ones bit for bit, a no-grad forward keeps at
  most the two largest units' bytes gathered, and a rank holds its slices
  and the replicated leaves.
- gloo ranks (`tests/torch_fsdp_worker.py`, spawned on free ports with a
  timeout, stderr shown on failure): ``data 2 x fsdp 2`` bit-equal to
  ``data 2 x fsdp 1`` and ``data 1 x fsdp 2`` bit-equal to one process, on
  the DDIM step (with and without remat, on int8 weights under ``fused``,
  and under ``dots8m+fa`` at ``block`` granularity, whose recompute of a
  BasicTransformerBlock gathers it again), the G and D steps, the fused
  pair and the SD3 flow step. The
  data-only ranks are held to JAX's global-batch step by
  `tests/test_torch_parallel.py`, so bit-equality carries that over.
- `dryrun_multichip(4, device="cpu")` prints JAX's four lines with finite
  losses; `entry(tiny=True)`'s forward runs.
"""

import functools
import math
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pcm_tpu.configs import families as jfamilies
from pcm_tpu.ops.common import reference_ops as jax_reference_ops
from pcm_tpu.parallel.mesh import fsdp_sharding
from pcm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pcm_tpu.utils import quant as jquant
from pcm_tpu_torch import dryrun
from pcm_tpu_torch.configs import families
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.parallel import fsdp, mesh
from pcm_tpu_torch.utils import quant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_fsdp_worker.py")
TIMEOUT = 240  # seconds, each spawn
CPU = torch.device("cpu")
FAMILIES = ("sd15", "sdxl", "sd3")


def _bundles(family: str):
    jmake = {"sd15": jfamilies.sd15_bundle, "sdxl": jfamilies.sdxl_bundle,
             "sd3": jfamilies.sd3_bundle}[family]
    pmake = {"sd15": families.sd15_bundle, "sdxl": families.sdxl_bundle,
             "sd3": families.sd3_bundle}[family]
    return jmake(4, tiny=True), pmake(4, tiny=True)


# ---------------------------------------------------------------------------
# the plan against JAX's
# ---------------------------------------------------------------------------


def _convert(key: str, tree, pb):
    if key in ("text", "text2"):
        return convert.clip_state_from_jax(tree, getattr(pb, key + "_cfg"))
    if key == "t5":
        return convert.t5_state_from_jax(tree, pb.t5_cfg)
    return convert.unet_state_from_jax(tree)  # the UNet, MMDiT and VAE rules are one


@functools.lru_cache(maxsize=None)
def _jax_shapes(family: str, int8: bool):
    if int8:  # the quantizer traced alone over the float tree's shapes
        return jax.eval_shape(lambda f: jquant.quantize_frozen(f, min_size=0),
                              _jax_shapes(family, False))
    jb, _ = _bundles(family)
    with jax_reference_ops():
        return jax.eval_shape(lambda key: jb.init(key, 32)[0], jax.random.PRNGKey(0))


def _jax_lengths(family: str, int8: bool, min_size: int):
    """{(module, diffusers name): JAX's split length or None}: every leaf of
    the JAX tree filled with its own index, carried through the converters
    (which transpose and rename), so each torch name finds its JAX leaf."""
    _, pb = _bundles(family)
    shapes = _jax_shapes(family, int8)
    specs = fsdp_sharding(jax_make_mesh(data=4, fsdp=2), shapes, min_size)
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda s: hasattr(s, "spec"))
    lengths = []
    for sds, s in zip(leaves, spec_leaves):
        axes = [i for i, a in enumerate(s.spec) if a == "fsdp"]
        lengths.append(sds.shape[axes[0]] if axes else None)
    probe = treedef.unflatten([np.full(sds.shape, i, np.float64) for i, sds in enumerate(leaves)])
    out = {}
    for key, tree in probe.items():
        for name, t in _convert(key, tree, pb).items():
            out[key, name] = lengths[int(t.reshape(-1)[0])]
    return out


@pytest.mark.parametrize("min_size", [2 ** 10, 2 ** 16])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_plan_matches_jax_fsdp_sharding(family, int8, min_size):
    """Every leaf of the port's TINY frozen modules (parameters and buffers)
    is split iff JAX's `fsdp_sharding` splits the leaf of the same name,
    over an axis of the same length."""
    ref = _jax_lengths(family, int8, min_size)
    _, pb = _bundles(family)
    frozen = pb.build(torch.device("meta"))
    if int8:
        quant.quantize_frozen(frozen, min_size=0)
    plan = fsdp.fsdp_plan(frozen, 2, min_size)
    ours = {}
    for (key, name), axis in plan.items():
        shape = dict(fsdp._named_leaves(frozen[key]))[name].shape
        ours[key, name] = None if axis is None else shape[axis]
    missing = sorted(set(ours) - set(ref))
    assert not missing, missing
    assert {k: ref[k] for k in ours} == ours
    assert any(v is not None for v in ours.values())
    if int8 and min_size == 2 ** 10:
        assert any(v is not None for (k, n), v in ours.items() if n.endswith("weight_values"))


@pytest.mark.parametrize("data,n_fsdp", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_layout_coordinates_match_jax_device_grid(data, n_fsdp):
    grid = jax_make_mesh(data=data, fsdp=n_fsdp).devices
    for i in range(data):
        for j in range(n_fsdp):
            assert mesh.coordinates(grid[i, j].id, n_fsdp) == (i, j)


def test_layout_without_a_process_group():
    layout = mesh.make_mesh()
    assert (layout.data, layout.fsdp, layout.data_index, layout.fsdp_index) == (1, 1, 0, 0)
    assert mesh.data_group() is None
    with pytest.raises(ValueError, match="does not fit"):
        mesh.make_mesh(1, 2)
    rows = layout.local_rows({"a": torch.arange(4)})
    assert rows["a"].tolist() == [0, 1, 2, 3]


def test_shard_axis_rule():
    """`pcm_tpu/parallel/mesh.py:fsdp_sharding`'s cases (`tests/test_sharding.py`)."""
    assert fsdp.shard_axis((640, 512), 2, 2 ** 10) == 0
    assert fsdp.shard_axis((641, 3), 2, 2 ** 10) is None
    assert fsdp.shard_axis((4,), 2, 2 ** 10) is None
    assert fsdp.shard_axis((3, 3, 320, 320), 2, 2 ** 10) == 2
    assert fsdp.shard_axis((640, 512), 1, 2 ** 10) is None


# ---------------------------------------------------------------------------
# shard -> gather in one process (two simulated ranks)
# ---------------------------------------------------------------------------


def _build(family: str, dtype, int8: bool):
    bundle = {"sd15": families.sd15_bundle, "sdxl": families.sdxl_bundle,
              "sd3": families.sd3_bundle}[family](4, dtype=dtype, tiny=True)
    frozen, template = bundle.init(torch.Generator().manual_seed(0), CPU)
    if int8:
        quant.quantize_frozen(frozen, min_size=0)
    return bundle, frozen, template


def _two_ranks(monkeypatch, family, dtype, int8, min_size=2 ** 10):
    """Two copies of the bundle sharded as ranks 0 and 1 of an fsdp group,
    the all-gather swapped for the concatenation of both copies' buffers."""
    bundle, ref, template = _build(family, dtype, int8)
    copies = [_build(family, dtype, int8)[1] for _ in range(2)]
    for r, frozen in enumerate(copies):
        fsdp.shard_fsdp(frozen, mesh.Layout(1, 2, 0, r), min_size)
    peers = {}
    for key in ref:
        for pair in zip(*(fsdp.units(c[key]) for c in copies)):
            assert pair[0].name == pair[1].name
            for u in pair:
                peers[id(u.flat)] = [v.flat for v in pair]

    def gather(out, inp, group):
        out.copy_(torch.cat(peers[id(inp)]))

    monkeypatch.setattr(fsdp, "all_gather", gather)
    return bundle, ref, copies, template


def _inputs(family: str, n: int = 2):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(n, 8, 8, 4, generator=g)
    t = torch.tensor([10.0, 700.0][:n])
    if family == "sd3":
        cond = {"prompt_embeds": torch.randn(n, 16, 32, generator=g),
                "pooled": torch.randn(n, 32, generator=g)}
    else:
        cond = {"prompt_embeds": torch.randn(n, 7, 32, generator=g)}
    if family == "sdxl":
        cond["added_cond"] = {"text_embeds": torch.randn(n, 32, generator=g),
                              "time_ids": torch.tensor([[32.0, 32, 0, 0, 32, 32]] * n)}
    pixels = torch.rand(n, 16, 16, 3, generator=g) * 2 - 1
    ids = torch.randint(1, 999, (n, 8), generator=g)
    return x, t, cond, pixels, ids


def _encode_prompts(bundle, frozen, ids, family):
    if family == "sd15":
        return bundle.encode_prompts(frozen, ids)["prompt_embeds"]
    if family == "sdxl":
        return bundle.encode_prompts(frozen, ids, ids, torch.zeros(len(ids), 6))["prompt_embeds"]
    return bundle.encode_prompts(frozen, ids, ids, ids)["prompt_embeds"]


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_shard_gather_round_trip_is_bit_exact(monkeypatch, family, int8):
    """Each leaf gathered from the two ranks' slices equals the unsharded
    leaf bit for bit, with its strides (the VAE's and the backbone's
    channels-last convs; int8 codes and scales); the slices are halves."""
    dtype = torch.bfloat16
    _, ref, copies, _ = _two_ranks(monkeypatch, family, dtype, int8)
    channels_last = split_int8 = 0
    for key, module in ref.items():
        want = dict(fsdp._named_leaves(module))
        got = fsdp.full_state(copies[0][key])
        assert set(got) == set(want)
        for name, t in want.items():
            assert got[name].stride() == t.stride(), (key, name)
            assert got[name].dtype == t.dtype and torch.equal(got[name], t), (key, name)
            channels_last += t.ndim == 4 and t.stride()[1] == 1 and t.shape[1] > 1
        for unit in fsdp.units(copies[0][key]):
            for leaf in unit.leaves:
                assert leaf.shard.shape[leaf.axis] * 2 == leaf.shape[leaf.axis]
                split_int8 += leaf.dtype == torch.int8
    assert channels_last > 0
    assert split_int8 > 0 if int8 else split_int8 == 0


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_forwards_equal_unsharded(monkeypatch, family):
    """The teacher's forward and taps, the student's forward and its LoRA
    gradients (remat off, on, on at ``block`` granularity, and under
    ``dots8m+fa`` there), the VAE encode and decode and the prompt encoding
    on sharded weights equal the unsharded ones bit for bit."""
    bundle, ref, copies, template = _two_ranks(monkeypatch, family, torch.float32, False)
    sharded = copies[0]
    x, t, cond, pixels, ids = _inputs(family)
    lora = {k: v + 0.01 for k, v in template.items()}

    backbone = "mmdit" if family == "sd3" else "unet"

    def readings(frozen, remat, policy=None, granularity="module"):
        b = bundle
        frozen[backbone].remat, frozen[backbone].remat_policy = remat, policy
        if backbone == "unet":
            frozen[backbone].remat_granularity = granularity
        lo = {k: v.clone().requires_grad_(True) for k, v in lora.items()}
        out = b.student(frozen, lo, x, t, cond)
        grads = torch.autograd.grad(out.square().sum(), list(lo.values()))
        with torch.no_grad():
            feats = b.teacher_features(frozen, x, t, cond)
            noise = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(1))
            lat = b.encode_pixels(frozen, pixels, noise)
            return [b.teacher(frozen, x, t, cond), out.detach(), *grads, *feats.values(), lat,
                    b.decode_latents(frozen, lat), _encode_prompts(b, frozen, ids, family)]

    for setting in ((False,), (True,), (True, None, "block"), (True, "dots8m+fa", "block")):
        for a, b in zip(readings(sharded, *setting), readings(ref, *setting)):
            assert torch.equal(a, b)


class _OneUnit(torch.nn.Linear):
    """A Linear that declares no unit inside it: it is gathered whole."""

    def fsdp_units(self):
        return []


def test_shard_fsdp_refuses_a_module_without_units():
    """A module with leaves to split that declares no `fsdp_units` is
    refused, and nothing of it is split; one whose leaves all replicate
    needs none."""
    big, small = torch.nn.Linear(256, 128), torch.nn.Linear(8, 4)
    with pytest.raises(TypeError, match="declares no fsdp_units"):
        fsdp.shard_fsdp({"m": big}, mesh.Layout(1, 2, 0, 0), min_size=2 ** 10)
    assert big.weight.shape == (128, 256) and not fsdp.units(big)
    fsdp.shard_fsdp({"m": small}, mesh.Layout(1, 2, 0, 0), min_size=2 ** 10)
    assert small.weight.shape == (4, 8) and not fsdp.units(small)


def test_sharded_linear_matmul_equals_unsharded(monkeypatch):
    """A Linear whose weight is split over the two ranks (`tests/test_sharding.py`'s
    matmul): its product equals the unsharded one."""
    g = torch.Generator().manual_seed(0)
    frozen = [{"m": _OneUnit(256, 128)} for _ in range(3)]
    for f in frozen:
        f["m"].requires_grad_(False)
        with torch.no_grad():
            f["m"].weight.copy_(torch.randn(128, 256, generator=torch.Generator().manual_seed(1)))
            f["m"].bias.zero_()
    ref, copies = frozen[0], frozen[1:]
    for r, f in enumerate(copies):
        fsdp.shard_fsdp(f, mesh.Layout(1, 2, 0, r), min_size=2 ** 10)
    (u0,), (u1,) = (fsdp.units(f["m"]) for f in copies)
    monkeypatch.setattr(fsdp, "all_gather",
                        lambda out, inp, group: out.copy_(torch.cat([u0.flat, u1.flat])))
    assert copies[0]["m"].weight.shape == (128, 128)  # the larger axis, in, split
    x = torch.randn(16, 256, generator=g)
    assert torch.equal(copies[0]["m"](x), ref["m"](x))
    assert copies[0]["m"].weight.shape == (128, 128)  # the slice back after the call


@pytest.mark.parametrize("family", FAMILIES)
def test_gather_discipline(monkeypatch, family):
    """A no-grad teacher forward keeps at most the two largest units'
    bytes gathered at once; at rest a rank holds its slices (each unit's
    buffer, slices aligned to 16 bytes) and the replicated leaves."""
    bundle, ref, copies, _ = _two_ranks(monkeypatch, family, torch.float32, False)
    sharded = copies[0]
    x, t, cond, _, _ = _inputs(family)
    backbone = "mmdit" if family == "sd3" else "unet"
    sizes = sorted((sum(math.prod(l.shape) * l.shard.element_size() for l in u.leaves)
                    for u in fsdp.units(sharded[backbone])), reverse=True)
    fsdp.reset_gather_stats()
    base = fsdp.gather_stats()["live_bytes"]
    with torch.no_grad():
        bundle.teacher(sharded, x, t, cond)
    s = fsdp.gather_stats()
    assert s["gathers"] == len(sizes) and s["live_bytes"] == base
    assert 0 < s["peak_live_bytes"] - base <= sizes[0] + sizes[1]

    plan = fsdp.fsdp_plan(ref, 2, 2 ** 10)
    allowed = 0
    for (key, name), axis in plan.items():
        t_ = dict(fsdp._named_leaves(ref[key]))[name]
        nbytes = t_.numel() * t_.element_size()
        allowed += nbytes if axis is None else -(-(nbytes // 2) // 16) * 16
    held = fsdp.held_bytes(sharded)
    assert held <= allowed
    assert held < 0.6 * fsdp.held_bytes(ref)


def test_units_gather_once_per_call_and_raise_without_peers(monkeypatch):
    """Each unit's all-gather runs once per call of its module; a gather
    that fails raises out of the forward, and nothing runs on a slice."""
    bundle, ref, copies, _ = _two_ranks(monkeypatch, "sd15", torch.float32, False)
    x, t, cond, _, _ = _inputs("sd15")

    def broken(out, inp, group):
        raise RuntimeError("peer gone")

    monkeypatch.setattr(fsdp, "all_gather", broken)
    with pytest.raises(RuntimeError, match="peer gone"):
        bundle.teacher(copies[0], x, t, cond)


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
               OMP_NUM_THREADS="1")
    return env


LAYOUTS = {"d2f2": (2, 2), "d2f1": (2, 1), "d1f2": (1, 2), "one": (1, 1)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every layout's ranks, all spawned at once: ``{layout: [rank results]}``."""
    out_dir = tmp_path_factory.mktemp("fsdp")
    procs = []
    for tag, (data, n_fsdp) in LAYOUTS.items():
        world, port = data * n_fsdp, _free_port()
        for r in range(world):
            procs.append((tag, r, subprocess.Popen(
                [sys.executable, WORKER, str(r), str(world), str(port), str(data), str(n_fsdp),
                 str(out_dir / f"{tag}_{r}.pt")], cwd=REPO, env=_env(), text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    try:
        errs = [(tag, r, p.communicate(timeout=TIMEOUT)[1], p) for tag, r, p in procs]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"{tag} rank {r} rc {p.returncode}:\n{err[-3000:]}" for tag, r, err, p in errs
              if p.returncode]
    assert not failed, "\n---\n".join(failed)
    res = {}
    for tag, (data, n_fsdp) in LAYOUTS.items():
        res[tag] = [torch.load(out_dir / f"{tag}_{r}.pt", weights_only=False)
                    for r in range(data * n_fsdp)]
    return res


JOB_NAMES = ("ddim", "ddim_remat", "adv_g_d", "adv_fused", "flow", "ddim_int8", "ddim_block_fa")


def _same(a: dict, b: dict) -> bool:
    trees = [k for k in ("params", "d_params") if k in b]
    return (set(a["metrics"]) == set(b["metrics"])
            and all(torch.equal(a["metrics"][k], v) for k, v in b["metrics"].items())
            and all(torch.equal(a[t][k], v) for t in trees for k, v in b[t].items()))


@pytest.mark.parametrize("job", JOB_NAMES)
def test_data2_fsdp2_equals_data2_fsdp1(ranks, job):
    """Four gloo ranks at ``data 2 x fsdp 2``: rank (d, f) computes bit for
    bit what rank d of the ``data 2 x fsdp 1`` run computes (losses, new
    LoRA, new heads), and every rank ends with the same state."""
    for out in ranks["d2f2"]:
        d = out["layout"][2]
        assert _same(out[job], ranks["d2f1"][d][job]), (job, out["layout"])
        assert _same(out[job], ranks["d2f2"][0][job])
        assert out[job]["stats"]["gathers"] > 0
    assert all(out[job]["stats"]["gathers"] == 0 for out in ranks["d2f1"])
    assert all(math.isfinite(float(v)) for v in ranks["d2f2"][0][job]["metrics"].values())


@pytest.mark.parametrize("job", JOB_NAMES)
def test_data1_fsdp2_equals_one_process(ranks, job):
    """Two gloo ranks at ``data 1 x fsdp 2`` (each holding half the split
    weights, gathering a block at a time) compute bit for bit what one
    process with no process group computes."""
    for out in ranks["d1f2"]:
        assert out["layout"] == (1, 2, 0, out["layout"][3])
        assert _same(out[job], ranks["one"][0][job]), job
        assert out[job]["stats"]["gathers"] > 0


# ---------------------------------------------------------------------------
# the dry run and the entry
# ---------------------------------------------------------------------------


def test_dryrun_multichip_four_cpu_ranks(capsys):
    """JAX's four lines, ``mesh={'data': 2, 'fsdp': 2}`` first, each with
    finite losses."""
    lines = dryrun.dryrun_multichip(4, device="cpu")
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun")]
    assert printed == lines and len(lines) == 4
    assert lines[0].startswith("dryrun_multichip(4): mesh={'data': 2, 'fsdp': 2} ddim loss=")
    for line, kind in zip(lines, ("ddim loss", "adv g_loss", "fused pair loss", "flow loss")):
        assert kind in line and line.endswith(" OK")
        values = [float(v) for v in re.findall(r"loss=(\S+)", line)]
        assert values and all(math.isfinite(v) for v in values)
    assert " D d_loss=" in lines[1]


def test_entry_tiny_forward_runs():
    fn, args = dryrun.entry(tiny=True, device="cpu")
    lora, x, t, ctx, added = args
    assert x.shape == (1, 8, 8, 4) and ctx.shape == (1, 77, 32) and x.dtype == torch.bfloat16
    assert len(lora) > 0 and all(float(v.abs().max()) == 0 for k, v in lora.items()
                                 if k.endswith("lora_b"))
    with torch.no_grad():
        y = fn(*args)
    assert y.shape == x.shape and bool(torch.isfinite(y.float()).all())
