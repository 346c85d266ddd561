"""Port diffusers/transformers safetensors into the port's teacher file
(counterpart of `scripts/port_weights.py`).

  python -m pcm_tpu_torch.port_weights --family sd15 --output ckpts/sd15.pt \\
      --unet 'sd15/unet/*.safetensors' --vae 'sd15/vae/*.safetensors' \\
      --text 'sd15/text_encoder/*.safetensors'
  python -m pcm_tpu_torch.port_weights --family sd3 --output ckpts/sd3.pt \\
      --unet 'sd3/transformer/*.safetensors' --vae 'sd3/vae/*.safetensors' \\
      --text 'sd3/text_encoder/*.safetensors' --text2 'sd3/text_encoder_2/*.safetensors' \\
      --t5 'sd3/text_encoder_3/*.safetensors'

The output is a ``torch.save``d dict of state dicts, ``{"unet", "vae",
"text"}`` (SDXL: also ``"text2"``; SD3: ``"mmdit"``, ``"vae"``, ``"text"``,
``"text2"``, ``"t5"``), which ``--teacher-checkpoint`` of ``train``,
``serving``, ``data.cache_latents`` and ``generate`` reads. Each flag takes
globs; a sharded set (SD3's two-file ``text_encoder_3``) is merged in sorted
order. F32, F16 and BF16 tensors keep the file's dtype: the bundle casts
each to its own when it loads the file (``from_states``).

It is host work with no model compute: the bundle's modules are built on
the ``meta`` device for their keys and shapes. The UNet, VAE, CLIP and T5
modules carry the diffusers / transformers names; the MMDiT keeps the JAX
tree's, so its keys are read under diffusers' names as
`pcm_tpu/models/convert.py:convert_mmdit_torch_state` reads them (its
position table reshaped to (1, max, max, dim)). A key is read under no
other name than the JAX converters read it (T5's embedding is
``shared.weight``). Tensors nothing reads are ignored (CLIP's int64
``position_ids``), except an optional layer the converters take when the
file holds it (``conv_shortcut``, ``time_emb_proj``, ``add_embedding``,
``to_add_out``, ``ff_context``) and the module lacks. A key the file lacks
prints ``MISSING:``, such a layer ``EXTRA:``, a key in the wrong shape
``SHAPE:``, each on stderr, and the command exits 1 without writing.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, List, Tuple

import torch

# family -> (module, flag) of each module of its teacher file
FAMILY_MODULES = {
    "sd15": (("unet", "unet"), ("vae", "vae"), ("text", "text")),
    "sdxl": (("unet", "unet"), ("vae", "vae"), ("text", "text"), ("text2", "text2")),
    "sd3": (("mmdit", "unet"), ("vae", "vae"), ("text", "text"), ("text2", "text2"),
            ("t5", "t5")),
}

# the layers the JAX converters take only when the file holds them
OPTIONAL = {
    "unet": re.compile(r"\.(conv_shortcut|time_emb_proj)\.|^add_embedding\."),
    "vae": re.compile(r"\.conv_shortcut\."),
    "mmdit": re.compile(r"\.attn\.to_add_out\.|\.ff_context\."),
}

_MMDIT_ATTN = ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0",
               "to_add_out")
_MMDIT_RENAMES = [(re.compile(r"^(timestep|text)_embedder\."), r"time_text_embed.\1_embedder."),
                  (re.compile(r"^(transformer_blocks\.\d+)\.(%s)\." % "|".join(
                      re.escape(n) for n in _MMDIT_ATTN)), r"\1.attn.\2.")]


def file_key(module: str, key: str) -> str:
    """The name under which the hub file holds ``module``'s state-dict key."""
    if module == "mmdit":
        for pattern, repl in _MMDIT_RENAMES:
            key = pattern.sub(repl, key)
    return key


def _layout(module: str, key: str, t: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """A file tensor in the module's layout: the MMDiT's (1, max * max, dim)
    position table as (1, max, max, dim); any other as it is."""
    if module == "mmdit" and key == "pos_embed.pos_embed" and t.numel() == shape.numel():
        return t.reshape(shape)
    return t


def port_module(module: str, expected: Dict[str, torch.Size], held: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The state dict of ``module`` from the file's tensors ``held``, and
    the ``MISSING:`` / ``EXTRA:`` / ``SHAPE:`` lines of what does not fit
    (``expected``: the module's keys and shapes)."""
    out, problems, read = {}, [], set()
    for key, shape in expected.items():
        name = file_key(module, key)
        read.add(name)
        if name not in held:
            problems.append(f"MISSING: {module}.{key} (file key {name})")
            continue
        t = _layout(module, key, held[name], shape)
        if t.shape != shape:
            problems.append(f"SHAPE:   {module}.{key}: file {tuple(held[name].shape)}, "
                            f"module {tuple(shape)}")
            continue
        out[key] = t
    optional = OPTIONAL.get(module)
    if optional is not None:
        problems += [f"EXTRA:   {module}: file key {name}" for name in sorted(held)
                     if name not in read and optional.search(name)]
    return out, problems


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcm_tpu_torch.port_weights")
    ap.add_argument("--family", required=True, choices=sorted(FAMILY_MODULES))
    ap.add_argument("--output", required=True, help="the teacher file to write (torch.save)")
    ap.add_argument("--unet", nargs="+", help="UNet / MMDiT safetensors (globs)")
    ap.add_argument("--vae", nargs="+")
    ap.add_argument("--text", nargs="+", help="text_encoder (CLIP-L)")
    ap.add_argument("--text2", nargs="+", help="text_encoder_2 (bigG)")
    ap.add_argument("--t5", nargs="+", help="text_encoder_3 (T5-XXL)")
    ap.add_argument("--tiny", action="store_true", help="TINY model configs (smoke/test mode)")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    from .configs.families import sd3_bundle, sd15_bundle, sdxl_bundle
    from .utils.safetensors import load_torch

    modules = FAMILY_MODULES[args.family]
    unset = [f"--{flag}" for _, flag in modules if not getattr(args, flag)]
    if unset:
        ap.error(f"--family {args.family} needs {' '.join(unset)}")
    bundle = {"sd15": sd15_bundle, "sdxl": sdxl_bundle, "sd3": sd3_bundle}[args.family](
        tiny=args.tiny)
    meta = bundle.build(torch.device("meta"))
    states, problems, n = {}, [], 0
    for module, flag in modules:
        expected = {k: v.shape for k, v in meta[module].state_dict().items()}
        try:
            held = load_torch(getattr(args, flag))
        except FileNotFoundError as e:
            ap.error(f"--{flag}: {e}")
        states[module], bad = port_module(module, expected, held)
        problems += bad
        n += sum(t.numel() for t in states[module].values())
        del held
    if problems:
        for line in problems:
            print(line, file=sys.stderr)
        raise SystemExit(1)
    tmp = args.output + ".tmp"
    torch.save(states, tmp)
    os.replace(tmp, args.output)
    print(f"ported {n / 1e6:.1f}M params -> {args.output}")


if __name__ == "__main__":
    main()
