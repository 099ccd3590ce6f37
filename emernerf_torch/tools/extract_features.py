"""DINO / DINOv2 feature extraction for feature lifting (port of
``emernerf_tpu/tools/extract_features.py``).

Counterpart of the reference's third_party/feature_extractor.py: runs a
ViT over each scene image with a reduced patch stride, captures an
intermediate facet, and writes one fp16 ``.npy`` feature map per image
(skipping maps that already exist, so that an interrupted run resumes,
feature_extractor.py:61-63).  It runs on the card unless the caller asks
for the CPU; the Waymo loader calls it for the maps a scene lacks
(``data.pixel_source.skip_feature_extraction=false``).

The model is read from local files only, never fetched: ``--model_path``
names a transformers checkpoint directory, or the hub model's repository
lies in the ``torch.hub`` cache (``<torch.hub.get_dir()>/
facebookresearch_dinov2_main/hubconf.py`` for the dinov2 models) and is
loaded from there with ``source="local"``.  The repository ships no
weights.

    python -m emernerf_torch.tools.extract_features --data_path \\
        data/waymo/processed/training/000
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np

from emernerf_torch import resolve_device

logger = logging.getLogger("emernerf_torch")


def _load_model(model_type: str, model_path: str = None, device="cuda"):
    if model_path and os.path.isdir(model_path):
        from transformers import AutoImageProcessor, AutoModel

        processor = AutoImageProcessor.from_pretrained(model_path)
        model = AutoModel.from_pretrained(model_path).to(device).eval()
        return model, processor, "transformers"
    import torch

    # where torch.hub.load("facebookresearch/dinov2", ...) caches the repository
    repo = "dinov2" if "dinov2" in model_type else "dino"
    repo_dir = os.path.join(torch.hub.get_dir(), f"facebookresearch_{repo}_main")
    if not os.path.isfile(os.path.join(repo_dir, "hubconf.py")):
        raise RuntimeError(
            f"Could not load {model_type}: no torch.hub cache of its repository at {repo_dir}. "
            "Provide --model_path with a local transformers checkpoint, or pre-populate the "
            "torch.hub cache.")
    model = torch.hub.load(repo_dir, model_type, source="local").to(device).eval()
    return model, None, "hub"


def extract_and_save_features(
    input_img_path_list,
    saved_feat_path_list,
    model_type: str = "dinov2_vitb14",
    model_path: str = None,
    extraction_size=(644, 966),
    device="cuda",
    stride: int = 7,
    layer: int = 11,
    facet: str = "key",
):
    """Extract per-image feature maps and save them as fp16 .npy (H_p, W_p, C).

    Hub dino/dinov2 models go through :class:`ViTFeatureExtractor`:
    reduced patch stride, re-interpolated positional embeddings and the
    intermediate-layer facet, as the reference extracts them
    (feature_extractor.py:16-83: layer 11, facet "key").  The transformers
    route (a local checkpoint) keeps the plain last-hidden-state path and
    logs that its features differ."""
    import torch
    from PIL import Image

    dev = resolve_device(device)
    model, processor, kind = _load_model(model_type, model_path, dev)
    h, w = extraction_size

    if kind == "hub":
        from emernerf_torch.tools.vit_extractor import ViTFeatureExtractor, preprocess_image

        extractor = ViTFeatureExtractor(model, model_type=model_type, stride=stride, device=dev)
        for img_path, feat_path in zip(input_img_path_list, saved_feat_path_list):
            if os.path.exists(feat_path):
                continue
            os.makedirs(os.path.dirname(feat_path), exist_ok=True)
            x = preprocess_image(img_path, (h, w), model_type).to(dev)
            feat = extractor.extract(x, layer=layer, facet=facet)[0]
            feat = feat.cpu().numpy()
            np.save(feat_path, feat.astype(np.float16))
            logger.info("saved %s %s", feat_path, feat.shape)
        return

    logger.warning(
        "Using transformers last-hidden-state features (no stride override "
        "/ facet capture); these will NOT match reference DINO features.")
    patch = 14 if "dinov2" in model_type else 8
    h, w = h - h % patch, w - w % patch
    for img_path, feat_path in zip(input_img_path_list, saved_feat_path_list):
        if os.path.exists(feat_path):
            continue
        os.makedirs(os.path.dirname(feat_path), exist_ok=True)
        img = Image.open(img_path).convert("RGB").resize((w, h))
        arr = np.asarray(img, np.float32) / 255.0
        # imagenet normalization
        arr = (arr - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225]
        x = torch.from_numpy(arr).permute(2, 0, 1)[None].float().to(dev)
        with torch.no_grad():
            out = model(pixel_values=x).last_hidden_state[0, 1:]
        feat = out.reshape(h // patch, w // patch, -1).cpu().numpy()
        np.save(feat_path, feat.astype(np.float16))
        logger.info("saved %s %s", feat_path, feat.shape)


def delete_features(feat_dir: str) -> None:
    """Remove the feature maps of a scene to reclaim disk
    (feature_extractor.py:86-107; ``data.pixel_source.delete_features_after_run``)."""
    for f in glob.glob(os.path.join(feat_dir, "*.npy")):
        os.remove(f)


def main(argv=None):
    p = argparse.ArgumentParser("Extract DINO features for a scene")
    p.add_argument("--data_path", required=True,
                   help="preprocessed scene dir (with images/)")
    p.add_argument("--model_type", default="dinov2_vitb14")
    p.add_argument("--model_path", default=None,
                   help="local transformers checkpoint dir")
    p.add_argument("--height", type=int, default=644)
    p.add_argument("--width", type=int, default=966)
    p.add_argument("--device", default="cuda")
    p.add_argument("--stride", type=int, default=7,
                   help="patch-embed stride override (7 for dinov2_vitb14, "
                        "8/4 for dino_vitb8)")
    p.add_argument("--layer", type=int, default=11)
    p.add_argument("--facet", default="key",
                   choices=["key", "query", "value", "token"])
    args = p.parse_args(argv)

    imgs = sorted(glob.glob(os.path.join(args.data_path, "images", "*.jpg")))
    feats = [os.path.join(args.data_path, args.model_type,
                          os.path.basename(f).replace(".jpg", ".npy")) for f in imgs]
    extract_and_save_features(
        imgs, feats, args.model_type, args.model_path,
        (args.height, args.width), args.device,
        stride=args.stride, layer=args.layer, facet=args.facet,
    )


if __name__ == "__main__":
    main()
