"""ViT dense-feature extractor with patch-stride override (port of
``emernerf_tpu/tools/vit_extractor.py``, held to it bit for bit by
``tests/test_torch_vit_extractor.py``).

Reproduces the reference's extraction semantics
(third_party/feature_extractor.py:110-483):

  * **stride override**: the ViT's patch-embedding convolution is run with
    a stride smaller than the patch size, giving overlapping patches and a
    denser feature grid: ``H_p = 1 + (H - patch) // stride``;
  * **positional-embedding re-interpolation**: the pretrained pos-emb grid
    (sized for stride == patch) is bicubically resampled to the strided
    token grid, because the model's own interpolation assumes
    non-overlapping patches;
  * **facet capture**: a forward hook on an attention block recomputes
    its qkv projection and keeps one facet; EmerNeRF uses the layer-11
    "key" facet, not the output tokens;
  * **register-token strip** for dinov2+reg models.

Works with facebookresearch dino / dinov2 hub models (standard ViT
attribute layout: ``patch_embed.proj``, ``pos_embed``, ``blocks[i].attn
.qkv``).  The extractor runs on the device its caller names.
"""

from __future__ import annotations

import math
import types
from typing import List, Optional, Tuple

import numpy as np


def _patch_size(model) -> int:
    ps = model.patch_embed.patch_size
    return ps if isinstance(ps, int) else ps[0]


def make_strided_pos_interp(patch_size: int, stride: Tuple[int, int]):
    """Replacement ``interpolate_pos_encoding(self, x, w, h)`` bound method:
    resamples the pretrained (sqrt(N) x sqrt(N)) patch pos-emb grid to the
    overlapping-patch token grid via bicubic interpolation."""
    import torch
    import torch.nn.functional as F

    def interpolate_pos_encoding(self, x, w, h):
        n_tokens = x.shape[1] - 1
        n_pretrained = self.pos_embed.shape[1] - 1
        if n_tokens == n_pretrained and w == h:
            return self.pos_embed
        dim = x.shape[-1]
        cls_pe = self.pos_embed[:, :1]
        patch_pe = self.pos_embed[:, 1:]
        side = int(math.sqrt(n_pretrained))
        w0 = 1 + (w - patch_size) // stride[1]
        h0 = 1 + (h - patch_size) // stride[0]
        if w0 * h0 != n_tokens:
            raise ValueError(
                f"token grid {h0}x{w0} does not match {n_tokens} tokens for "
                f"input {h}x{w}, patch {patch_size}, stride {stride}"
            )
        grid = patch_pe.reshape(1, side, side, dim).permute(0, 3, 1, 2)
        # a small epsilon guards float scale rounding, as DINO's own code does
        grid = F.interpolate(
            grid,
            scale_factor=((h0 + 0.1) / side, (w0 + 0.1) / side),
            mode="bicubic",
            align_corners=False,
            recompute_scale_factor=False,
        )
        assert grid.shape[-2] == h0 and grid.shape[-1] == w0
        flat = grid.permute(0, 2, 3, 1).reshape(1, h0 * w0, dim)
        return torch.cat([cls_pe, flat], dim=1)

    return interpolate_pos_encoding


def override_patch_stride(model, stride: int):
    """Run the patch-embed conv with a reduced stride and patch the model's
    pos-emb interpolation accordingly.  No-op when stride == patch size."""
    p = _patch_size(model)
    if stride == p:
        return model
    if p % stride != 0:
        raise ValueError(f"stride {stride} must divide patch size {p}")
    model.patch_embed.proj.stride = (stride, stride)
    model.interpolate_pos_encoding = types.MethodType(
        make_strided_pos_interp(p, (stride, stride)), model
    )
    return model


class ViTFeatureExtractor:
    """Dense intermediate-facet features from a dino/dinov2-style ViT."""

    def __init__(self, model, model_type: str = "dino_vitb8",
                 stride: Optional[int] = None, *, device):
        self.model = model.eval().to(device)
        self.model_type = model_type
        self.device = device
        self.patch = _patch_size(model)
        if stride is not None:
            override_patch_stride(self.model, stride)
        s = self.model.patch_embed.proj.stride
        self.stride = s if isinstance(s, tuple) else (s, s)
        # dinov2-with-registers models carry 4 register tokens after cls
        self.num_register_tokens = int(
            getattr(model, "num_register_tokens", 0)
            or (4 if "reg" in model_type else 0)
        )
        self._captured: List = []

    # ---------------------------------------------------------------- #
    def _facet_hook(self, facet: str):
        idx = {"query": 0, "key": 1, "value": 2}[facet]

        def hook(module, inputs, output):
            import torch

            x = inputs[0]
            b, n, c = x.shape
            heads = module.num_heads
            qkv = module.qkv(x).reshape(b, n, 3, heads, c // heads)
            # (B, heads, tokens, head_dim)
            self._captured.append(
                qkv.permute(2, 0, 3, 1, 4)[idx].detach()
            )

        return hook

    def _token_hook(self, module, inputs, output):
        self._captured.append(
            output[0] if isinstance(output, tuple) else output
        )

    # ---------------------------------------------------------------- #
    def num_patches(self, h: int, w: int) -> Tuple[int, int]:
        return (
            1 + (h - self.patch) // self.stride[0],
            1 + (w - self.patch) // self.stride[1],
        )

    def extract(self, batch, layer: int = 11, facet: str = "key"):
        """batch: (B, 3, H, W) normalized tensor -> (B, H_p, W_p, C)
        features of the chosen facet (heads flattened into channels)."""
        import torch

        self._captured = []
        block = self.model.blocks[layer]
        if facet in ("query", "key", "value"):
            handle = block.attn.register_forward_hook(self._facet_hook(facet))
        elif facet == "token":
            handle = block.register_forward_hook(self._token_hook)
        else:
            raise ValueError(f"unsupported facet {facet}")
        try:
            with torch.no_grad():
                self.model(batch.to(self.device))
        finally:
            handle.remove()
        feats = self._captured[0]
        if facet in ("query", "key", "value"):
            b, heads, n, hd = feats.shape
            feats = feats.permute(0, 2, 1, 3).reshape(b, n, heads * hd)
        # strip cls (+ register) tokens
        feats = feats[:, 1 + self.num_register_tokens :, :]
        h, w = batch.shape[-2:]
        hp, wp = self.num_patches(h, w)
        if feats.shape[1] != hp * wp:
            raise ValueError(
                f"got {feats.shape[1]} patch tokens, expected {hp}x{wp}"
            )
        return feats.reshape(-1, hp, wp, feats.shape[-1])


def preprocess_image(path_or_img, load_size: Tuple[int, int],
                     model_type: str = "dino_vitb8"):
    """Image file -> normalized (1, 3, H, W) float tensor (dino uses
    imagenet stats, other models 0.5/0.5)."""
    import torch
    from PIL import Image

    img = path_or_img
    if isinstance(path_or_img, str):
        img = Image.open(path_or_img).convert("RGB")
    img = img.resize((load_size[1], load_size[0]), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    if "dino" in model_type:
        mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    else:
        mean, std = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
    arr = (arr - np.asarray(mean)) / np.asarray(std)
    return torch.from_numpy(arr.astype(np.float32)).permute(2, 0, 1)[None]
