"""CLIP score over a folder: the mean 100 * max(0, cos) prompt-image
alignment (counterpart of `scripts/eval_clip_score.py`, over
`utils/clip_score.py`):

  python -m pcm_tpu_torch.eval_clip_score --image-dir gen/ \\
      --vision-weights clip_vit_l14_vision.safetensors \\
      --text-weights clip_vit_l14_text.safetensors \\
      --tokenizer-dir /path/to/clip-tokenizer [--prompts-file prompts.txt] [--device cuda]

Images pair with prompts by order: one prompt per image from
``--prompts-file``, or each image's sidecar ``.txt`` caption. Images are
read by the port's numpy decoders and resized to the tower's 224 px square
(Lanczos-3, as PIL in the JAX script); prompts are tokenized by the port's
tokenizers (`data/tokenizer.py`: the native CLIP BPE from
``--tokenizer-dir``, else hashed ids, a smoke metric). Without
``--vision-weights`` / ``--text-weights`` the towers' weights are drawn from
a seed, with a warning.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcm_tpu_torch.eval_clip_score")
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--prompts-file", default=None,
                    help="one prompt per line, paired with sorted image files; "
                         "default: per-image sidecar .txt captions")
    ap.add_argument("--vision-weights", default=None,
                    help="HF CLIPVisionModelWithProjection ckpt (.safetensors/.bin)")
    ap.add_argument("--text-weights", default=None,
                    help="HF CLIPTextModelWithProjection ckpt (.safetensors/.bin)")
    ap.add_argument("--tokenizer-dir", default=None,
                    help="local CLIP tokenizer dir (vocab.json + merges.txt); fallback: "
                         "hash tokenizer (smoke only)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="where the CLIP towers run")
    return ap


def main(argv=None) -> float:
    """Parse ``argv``, print ``CLIP-score: <value>`` and return it."""
    from .data.dataset import list_image_files
    from .data.tokenizer import resolve_tokenizers
    from .eval_fid import load_images
    from .utils.clip_score import CLIPTextFeatures, clip_score_from_features
    from .utils.fid import CLIPFeatures

    ap = build_parser()
    args = ap.parse_args(argv)
    files = list_image_files(args.image_dir)
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts = [line.strip() for line in f if line.strip()]
        if len(prompts) != len(files):
            ap.error(f"{len(prompts)} prompts for {len(files)} images")
    else:
        prompts = []
        for f in files:
            cap = os.path.splitext(f)[0] + ".txt"
            if not os.path.exists(cap):
                ap.error(f"no sidecar caption for {f}; use --prompts-file")
            with open(cap) as fh:
                prompts.append(fh.read().strip())

    tok = resolve_tokenizers(args.tokenizer_dir, ["input_ids"])["input_ids"]
    kw = {"batch": args.batch, "device": args.device}
    img_ex = (CLIPFeatures.from_torch_file(args.vision_weights, **kw) if args.vision_weights
              else CLIPFeatures(**kw))
    txt_ex = (CLIPTextFeatures.from_torch_file(args.text_weights, tok, **kw)
              if args.text_weights else CLIPTextFeatures(tok, **kw))
    res = img_ex.cfg.image_size
    feats_i, feats_t = [], []
    for i in range(0, len(files), args.batch):
        feats_i.append(img_ex(load_images(files[i:i + args.batch], res)))
        feats_t.append(txt_ex(prompts[i:i + args.batch]))
    score = clip_score_from_features(np.concatenate(feats_i), np.concatenate(feats_t))
    print(f"CLIP-score: {score:.4f}")
    return score


if __name__ == "__main__":
    main()
