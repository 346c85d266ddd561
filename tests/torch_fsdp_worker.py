"""One rank of the FSDP steps of `tests/test_torch_fsdp.py`.

    python tests/torch_fsdp_worker.py <rank> <world> <port> <data> <fsdp> <out.pt>

With ``world > 1`` it joins a gloo process group on the CPU
(``127.0.0.1:<port>``) and makes the ``data x fsdp`` layout; with ``world
= 1`` it runs with no process group. Each job of `JOBS` runs one step of
the dry run's `pcm_tpu_torch/dryrun.py:step_runner` at TINY sizes
in fp32: the bundle from seed 0, the frozen weights sharded
(``min_size = 2**10``), this rank's rows of a global batch of ``2 x data``
rows and of the global draws (both from fixed seeds, the same on every
rank). It keeps the metrics, the new LoRA (and heads) and the gather
counters, and writes ``<out.pt>``: ``{job: result}`` and the layout.
"""

import os
import sys

import torch

from pcm_tpu_torch import dryrun
from pcm_tpu_torch.parallel import fsdp, mesh

CPU = torch.device("cpu")
# job -> (step kind of `dryrun.FAMILY_STEPS`, remat settings of `dryrun.Sizes`)
FULL = {"remat": True}
JOBS = {"ddim": ("ddim", {"remat": False}), "ddim_remat": ("ddim", FULL),
        "adv_g_d": ("adv_g_d", FULL), "adv_fused": ("adv_fused", FULL), "flow": ("flow", FULL),
        "ddim_int8": ("ddim_int8", FULL),
        "ddim_block_fa": ("ddim", {"remat": True, "remat_policy": "dots8m+fa",
                                   "remat_granularity": "block"})}


def run_job(name: str, layout: mesh.Layout) -> dict:
    kind, remat = JOBS[name]
    family = "sd3" if kind == "flow" else "sd15"
    sizes = dryrun.Sizes(**remat)
    bundle = dryrun.family_bundle(family, sizes)
    frozen, lora, _ = dryrun.sharded_frozen(bundle, sizes, layout, CPU, seed=0,
                                            int8=kind == "ddim_int8")
    glob = dryrun.tiny_batch(family, 2 * layout.data, seed=len(name))
    run = dryrun.step_runner(kind, bundle, layout, glob, lora, seed=7, tiny=True)
    fsdp.reset_gather_stats()
    metrics, g, d = run(frozen)
    return {"metrics": metrics, "params": g.params, "d_params": d.params if d is not None else {},
            "stats": fsdp.gather_stats()}


def main() -> None:
    rank, world, port, data, n_fsdp = (int(a) for a in sys.argv[1:6])
    torch.set_num_threads(1)
    if world > 1:
        mesh.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    layout = mesh.make_mesh(data, n_fsdp)
    out = {name: run_job(name, layout) for name in JOBS}
    out["layout"] = (layout.data, layout.fsdp, layout.data_index, layout.fsdp_index)
    mesh.barrier("jobs done")
    torch.save(out, sys.argv[6])
    if world > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
