"""Few-step generation demo on a CUDA card (counterpart of `demo/app.py`).

  python -m pcm_tpu_torch.demo --family sd15 --teacher-checkpoint ckpts/sd15.pt \\
      --lora-dir loras/ [--tokenizer-dir tok/] [--weights int8] \\
      [--safety-concepts concepts.npz --safety-clip-weights clip_vision.safetensors]

The flags are the JAX script's, and ``--device`` (``cuda``; ``--tiny --device
cpu`` runs the TINY configuration at 32 px, the vision tower too, through the
kernels' plain versions). ``CHECKPOINT_REGISTRY`` maps each released PCM
LoRA variant to its file under ``--lora-dir`` and its steps, scheduler and
guidance; a mode whose file is missing samples the teacher.
``--teacher-checkpoint`` is the file ``python -m pcm_tpu_torch.port_weights``
writes. Images come from `generate.py`'s pipeline, so a seed gives
``python -m pcm_tpu_torch.generate``'s image for the same teacher, LoRA,
steps, scheduler and guidance. ``--safety-concepts`` turns on the safety
checker (`utils/safety.py`), which needs ``--safety-clip-weights`` (the CLIP
ViT-L/14 vision tower) for the image features; a flagged image is returned
black. Without gradio, a CLI loop reads prompts from stdin (an empty line or
the end of input stops it) and writes each image, the "2-Step" mode at seed
0, to ``demo_out.png``.
"""

from __future__ import annotations

import argparse
import copy
import functools
import os

import numpy as np

CHECKPOINT_REGISTRY = {
    # name -> (filename, steps, scheduler, default cfg)
    "2-Step": ("pcm_{family}_smallcfg_2step_converted.safetensors", 2, "ddim", 1.0),
    "4-Step": ("pcm_{family}_smallcfg_4step_converted.safetensors", 4, "ddim", 1.0),
    "8-Step": ("pcm_{family}_smallcfg_8step_converted.safetensors", 8, "ddim", 1.0),
    "16-Step": ("pcm_{family}_smallcfg_16step_converted.safetensors", 16, "ddim", 1.0),
    "Normal CFG 4-Step": ("pcm_{family}_normalcfg_4step_converted.safetensors", 4, "ddim", 7.5),
    "Normal CFG 8-Step": ("pcm_{family}_normalcfg_8step_converted.safetensors", 8, "ddim", 7.5),
    "Normal CFG 16-Step": ("pcm_{family}_normalcfg_16step_converted.safetensors", 16, "ddim",
                           7.5),
    "LCM-Like LoRA": ("pcm_{family}_lcmlike_lora_converted.safetensors", 4, "tcd", 1.0),
}
TINY_RESOLUTION = 32  # the JAX demo's --tiny resolution


def build_generator(args):
    """``generate(prompt, mode, seed=0)`` -> (H, W, 3) uint8, over the teacher
    loaded once; each mode's LoRA and sampler built on first use (4 kept)."""
    from . import generate as gen
    from .sampling.pipeline import TextToImagePipeline
    from .utils.png import to_uint8
    from .utils.safety import SafetyChecker

    gen_argv = ["--family", args.family, "--teacher-checkpoint", args.teacher_checkpoint,
                "--prompt", "", "--weights", args.weights, "--device", args.device]
    if args.tiny:
        gen_argv += ["--tiny", "--resolution", str(TINY_RESOLUTION)]
    if args.tokenizer_dir:
        gen_argv += ["--tokenizer-dir", args.tokenizer_dir]
    ap = gen.build_parser()
    base = ap.parse_args(gen_argv)
    gen.check_args(ap, base)
    built = gen.build(base)

    # the live safety checker (the reference's demo/safety_checker.py): CLIP
    # ViT-L/14 image features against concept embeddings. It needs BOTH the
    # concept npz and the vision tower's weights; anything less is announced.
    safety = SafetyChecker(args.safety_concepts)
    vision_extract = None
    if safety.active:
        if not args.safety_clip_weights:
            raise SystemExit("--safety-concepts requires --safety-clip-weights "
                             "(CLIP vision tower checkpoint) to compute image features")
        from .models.clip_vision import TINY_CLIP_VISION_CONFIG
        from .utils.fid import CLIPFeatures

        vision_extract = CLIPFeatures.from_torch_file(
            args.safety_clip_weights, cfg=TINY_CLIP_VISION_CONFIG if args.tiny else None,
            device=args.device)
        print("# safety checker ACTIVE (CLIP ViT-L/14 + concept embeddings)")
    else:
        print("# safety checker disabled (no --safety-concepts provided)")

    @functools.lru_cache(maxsize=4)
    def make_pipe(mode: str):
        fname, steps, scheduler, cfg = CHECKPOINT_REGISTRY[mode]
        path = os.path.join(args.lora_dir or "", fname.format(family=args.family))
        lora = None
        if args.lora_dir and os.path.exists(path):
            lora = gen.load_lora(built["bundle"], built["frozen"], args.family, path,
                                 built["device"])
        sampler = gen.make_sampler(args.family, scheduler, steps, base.shift)
        mode_args = copy.copy(base)
        mode_args.steps, mode_args.scheduler, mode_args.cfg = steps, scheduler, cfg
        mode_args.lora = path if lora is not None else None
        return dict(built, lora=lora, pipe=TextToImagePipeline(built["bundle"], sampler)), \
            mode_args

    def generate(prompt: str, mode: str, seed: int = 0) -> np.ndarray:
        mode_built, mode_args = make_pipe(mode)
        run_args = copy.copy(mode_args)
        run_args.prompt, run_args.seed = [prompt], seed
        img = gen.generate(mode_built, run_args).float().cpu().numpy()
        arr = to_uint8(img)[0]
        if vision_extract is not None:
            feats = vision_extract(img[:1])[0]
            if safety.is_unsafe(arr, image_features=feats):
                arr = np.zeros_like(arr)
        return arr

    return generate


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcm_tpu_torch.demo")
    ap.add_argument("--family", default="sd15", choices=["sd15", "sdxl"])
    ap.add_argument("--teacher-checkpoint", required=True,
                    help="the teacher file of `python -m pcm_tpu_torch.port_weights`")
    ap.add_argument("--lora-dir", default=None)
    ap.add_argument("--tokenizer-dir", default=None)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--weights", default="bf16", choices=["bf16", "int8"],
                    help="int8 = weight-only quantized frozen kernels")
    ap.add_argument("--safety-concepts", default=None,
                    help="npz with concept_embeds/_weights + special_care_* "
                         "(ported from the HF safety checker)")
    ap.add_argument("--safety-clip-weights", default=None,
                    help="CLIP ViT-L/14 vision checkpoint (.safetensors/.bin) for image features")
    ap.add_argument("--tiny", action="store_true",
                    help="TINY_* model configs at 32px (smoke/test mode)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> None:
    from .utils.png import write_png

    args = build_parser().parse_args(argv)
    generate = build_generator(args)
    try:
        import gradio as gr
    except ImportError:
        print("gradio not installed — interactive CLI mode")
        while True:
            try:
                prompt = input("prompt> ").strip()
            except EOFError:
                break
            if not prompt:
                break
            write_png("demo_out.png", generate(prompt, "2-Step"))
            print("wrote demo_out.png", flush=True)
        return

    with gr.Blocks(title="Phased Consistency Model (CUDA)") as demo:
        gr.Markdown("# PCM few-step generation (PyTorch + CUDA)")
        with gr.Row():
            prompt = gr.Textbox(label="Prompt")
            mode = gr.Dropdown(list(CHECKPOINT_REGISTRY), value="2-Step", label="Mode")
            seed = gr.Number(value=0, label="Seed", precision=0)
        btn = gr.Button("Generate")
        out = gr.Image(label="Result")
        btn.click(lambda p, m, s: generate(p, m, int(s)), [prompt, mode, seed], out)
    demo.launch(server_port=args.port)


if __name__ == "__main__":
    main()
