"""One rank of the data-parallel steps of `tests/test_torch_parallel.py`.

    python tests/torch_parallel_worker.py <rank> <world> <port> <jobs.pt> <out_dir>

Joins a gloo process group on the CPU (``127.0.0.1:<port>``), runs every
job of ``jobs.pt`` (`run_job`) on this rank's rows of its global batch and
draws, and writes ``<out_dir>/rank<rank>.pt`` with each job's result. The
test runs `run_job` itself with ``world=1`` for the one-process step on the
global batch.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

from pcm_tpu_torch.configs.families import RECIPES, disc_config, sd3_bundle, sd15_bundle
from pcm_tpu_torch.core.schedule import make_ddpm_schedule, make_flow_schedule
from pcm_tpu_torch.parallel import mesh
from pcm_tpu_torch.train import adv, distill
from pcm_tpu_torch.train.state import TrainState, make_optimizer

RANK, GROUPS, LR, EPS = 4, 8, 1e-3, 1e-2  # Adam's eps as tests/test_torch_train.py sets it
CPU = torch.device("cpu")


def sd15_tiny():
    """The TINY SD1.5 bundle of tests/test_torch_train.py (8 GroupNorm groups)."""
    tiny = sd15_bundle(RANK, dtype=torch.float32, tiny=True)
    return dataclasses.replace(tiny, unet_cfg=dataclasses.replace(tiny.unet_cfg,
                                                                  norm_groups=GROUPS))


def _rows(tree, rank, world):
    return mesh.local_rows({k: torch.from_numpy(np.array(v)) for k, v in tree.items()}, rank,
                           world)


def run_job(job: dict, rank: int, world: int) -> dict:
    """One optimizer step of ``job`` on rows ``rank`` of ``world`` of its
    global batch and of each global microbatch's draws; returns the metrics
    and the new parameters (the heads' too for an adversarial step)."""
    batch = _rows(job["batch"], rank, world)
    draws = [_rows(d, rank, world) for d in job["draws"]]
    if job["kind"] == "ddim":
        bundle = sd15_tiny()
        frozen, _ = bundle.init(torch.Generator().manual_seed(0), CPU)
        frozen["unet"].load_state_dict(job["unet"])
        tx = make_optimizer(LR, eps=EPS, use_8bit=job["use_8bit"])
        opt_state = job["opt_state"] if job["opt_state"] is not None else tx.init(job["params"])
        state = TrainState(0, job["params"], opt_state)
        step = distill.build_ddim_distill_step(bundle, make_ddpm_schedule(),
                                               distill.DistillConfig(**job["cfg"]), tx,
                                               grad_accum_steps=job["accum"])
        new, metrics = step(state, frozen, batch, draws)
        return {"metrics": metrics, "params": new.params}
    if job["kind"] == "flow":
        bundle = sd3_bundle(RANK, dtype=torch.float32, tiny=True)
        frozen, lora = bundle.init(torch.Generator().manual_seed(0), CPU, modules=("mmdit",))
        lora = {k: v + 0.01 for k, v in lora.items()}  # LoRA b factors away from zero
        tx = make_optimizer(LR, eps=EPS)
        step = distill.build_flow_distill_step(bundle, make_flow_schedule(shift=3.0),
                                               distill.DistillConfig(**job["cfg"]), tx)
        new, metrics = step(TrainState.create(lora, tx), frozen, batch, draws)
        return {"metrics": metrics, "params": new.params}
    # the sd15_2phase_adv fused pair
    recipe = RECIPES["sd15_2phase_adv"]
    bundle = sd15_tiny()
    frozen, lora = bundle.init(torch.Generator().manual_seed(0), CPU)
    lora = {k: v + 0.01 for k, v in lora.items()}
    disc, d_params = adv.init_discriminator(disc_config("sd15", tiny=True),
                                            bundle.unet_cfg.tap_channels(),
                                            torch.Generator().manual_seed(1), CPU)
    tx_g = make_optimizer(LR, eps=EPS)
    tx_d = make_optimizer(LR, b1=0.0, eps=EPS, max_grad_norm=1.0)
    step = adv.build_adv_train_step(bundle, make_ddpm_schedule(), job["distill"],
                                    adv.AdvConfig(recipe.adv_weight), disc, tx_g, tx_d, "fused")
    g, d, metrics, counted = step(TrainState.create(lora, tx_g), TrainState.create(d_params, tx_d),
                                  frozen, batch, draws, 0)
    return {"metrics": metrics, "params": g.params, "d_params": d.params, "counted": counted}


def main() -> None:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    jobs, out_dir = torch.load(sys.argv[4], weights_only=False), sys.argv[5]
    torch.set_num_threads(2)
    mesh.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    out = {name: run_job(job, rank, world) for name, job in jobs.items()}
    mesh.barrier("jobs done")
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
