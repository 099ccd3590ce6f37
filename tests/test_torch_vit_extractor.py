"""The port's ViT feature extractor (``emernerf_torch/tools/vit_extractor.py``)
against ``emernerf_tpu/tools/vit_extractor.py``, bit for bit (both are
torch on the CPU): ``tests/test_vit_extractor.py``'s tiny ViT with the
dino/dinov2 layout goes through both extractors with the same weights and
inputs, for the stride override, the pos-embed interpolation, every
facet, register tokens and ``preprocess_image``; and a model of the
layout ``chip_smoke.py`` serves through ``torch.hub`` (DINOv2's calling
convention, an input of other height and width)."""

import numpy as np
import pytest
import torch
from PIL import Image
from test_vit_extractor import DIM, TinyViT

import chip_smoke
from emernerf_tpu.tools import vit_extractor as jax_vit
from emernerf_torch.tools import vit_extractor as vit


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _twins(seed=0, **kw):
    torch.manual_seed(seed)
    a = TinyViT(**kw)
    b = TinyViT(**kw)
    b.load_state_dict(a.state_dict())
    return a, b


@pytest.mark.parametrize("stride", [None, 4, 2])
@pytest.mark.parametrize("facet", ["key", "query", "value", "token"])
def test_extract_matches_jax(stride, facet):
    ours_model, ref_model = _twins()
    ours = vit.ViTFeatureExtractor(ours_model, "dino_tiny", stride=stride, device="cpu")
    ref = jax_vit.ViTFeatureExtractor(ref_model, "dino_tiny", stride=stride)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    a, b = ours.extract(x, layer=1, facet=facet), ref.extract(x, layer=1, facet=facet)
    side = 1 + (32 - 8) // (stride or 8)
    assert a.shape == (2, side, side, DIM)
    assert torch.equal(a, b)
    assert ours.stride == ref.stride and ours.num_patches(32, 48) == ref.num_patches(32, 48)


def test_stride_override_and_pos_embed_interpolation_match_jax():
    ours_model, ref_model = _twins()
    vit.override_patch_stride(ours_model, 4)
    jax_vit.override_patch_stride(ref_model, 4)
    assert ours_model.patch_embed.proj.stride == ref_model.patch_embed.proj.stride == (4, 4)
    for hw, tokens in (((32, 32), 7 * 7), ((32, 48), 7 * 11), ((48, 32), 11 * 7)):
        x = torch.zeros(1, 1 + tokens, DIM)
        a = ours_model.interpolate_pos_encoding(x, hw[1], hw[0])
        assert a.shape == (1, 1 + tokens, DIM)
        assert torch.equal(a, ref_model.interpolate_pos_encoding(x, hw[1], hw[0]))
    # the pretrained count at a square input short-circuits to the table
    x = torch.zeros(1, 1 + 4 * 4, DIM)
    assert torch.equal(ours_model.interpolate_pos_encoding(x, 16, 16), ours_model.pos_embed)
    with pytest.raises(ValueError, match="does not match"):
        ours_model.interpolate_pos_encoding(torch.zeros(1, 1 + 30, DIM), 32, 32)
    with pytest.raises(ValueError, match="must divide"):
        vit.override_patch_stride(TinyViT(), 3)


@pytest.mark.parametrize("regs", [0, 4])
def test_register_tokens_stripped_as_jax(regs):
    """A dinov2+reg model carries its register tokens after cls: both
    extractors strip them (by attribute, or by 'reg' in the name)."""
    class RegViT(TinyViT):
        def forward(self, x):
            b, _, h, w = x.shape
            tokens = self.patch_embed(x)
            tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], 1)
            tokens = tokens + self.interpolate_pos_encoding(tokens, w, h)
            tokens = torch.cat([tokens[:, :1], self.reg.expand(b, -1, -1), tokens[:, 1:]], 1)
            for blk in self.blocks:
                tokens = blk(tokens)
            return tokens[:, 0]

    torch.manual_seed(0)
    a, b = RegViT(), RegViT()
    a.reg = torch.nn.Parameter(torch.randn(1, regs, DIM))
    b.load_state_dict(a.state_dict(), strict=False)
    b.reg = a.reg
    name = "dinov2_vits14_reg" if regs else "dino_tiny"
    ours = vit.ViTFeatureExtractor(a, name, stride=4, device="cpu")
    ref = jax_vit.ViTFeatureExtractor(b, name, stride=4)
    assert ours.num_register_tokens == ref.num_register_tokens == regs
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    out = ours.extract(x, layer=2, facet="key")
    assert out.shape == (1, 7, 7, DIM) and torch.equal(out, ref.extract(x, layer=2, facet="key"))


def test_unknown_facet_raises():
    ex = vit.ViTFeatureExtractor(TinyViT(), "dino_tiny", device="cpu")
    with pytest.raises(ValueError, match="unsupported facet"):
        ex.extract(torch.zeros(1, 3, 32, 32), layer=1, facet="attn")


@pytest.mark.parametrize("model_type", ["dino_vitb8", "dinov2_vitb14", "clip"])
def test_preprocess_image_matches_jax(tmp_path, model_type):
    rng = np.random.default_rng(3)
    p = tmp_path / "img.jpg"
    Image.fromarray((rng.random((20, 30, 3)) * 255).astype(np.uint8)).save(p)
    for source in (str(p), Image.open(p).convert("RGB")):
        a = vit.preprocess_image(source, (16, 24), model_type)
        b = jax_vit.preprocess_image(source, (16, 24), model_type)
        assert a.shape == (1, 3, 16, 24) and a.dtype == torch.float32
        assert torch.equal(a, b)


def _hub_module(tmp_path, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, chip_smoke.write_hubconf(str(tmp_path), **chip_smoke.TINY_HUB))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hub_layout_model_extracts_as_jax(tmp_path):
    """The layout chip_smoke.py serves through torch.hub (DINOv2's: the
    forward passes the input's height and width as ``w, h``), at tiny
    widths, on an input of other height and width: both extractors give
    the same (5, 7) grid, bit for bit."""
    mod = _hub_module(tmp_path, "tiny_hubconf")
    ours = vit.ViTFeatureExtractor(mod.dinov2_vitb14(), "dinov2_vitb14", stride=7, device="cpu")
    ref = jax_vit.ViTFeatureExtractor(mod.dinov2_vitb14(), "dinov2_vitb14", stride=7)
    x = torch.randn(1, 3, 42, 56, generator=torch.Generator().manual_seed(4))
    a = ours.extract(x, layer=11, facet="key")
    assert a.shape == (1, 5, 7, chip_smoke.TINY_HUB["dim"])
    assert torch.equal(a, ref.extract(x, layer=11, facet="key"))


def test_strided_pos_grid_takes_its_rows_from_h_as_the_reference(tmp_path):
    """Pins a fault the port shares with the reference (ROADMAP queue 3):
    the stride override interpolates the grid to rows from its ``h``
    argument, but DINO's forward passes the input's height as ``w``.  At a
    42 x 56 input (5 rows of 7 tokens) the embeddings come from a grid of 7
    rows of 5, read in token order, not from the 5 x 7 grid."""
    import torch.nn.functional as F

    mod = _hub_module(tmp_path, "pin_hubconf")
    dim, side = chip_smoke.TINY_HUB["dim"], chip_smoke.TINY_HUB["grid"]
    models = mod.dinov2_vitb14(), mod.dinov2_vitb14()
    vit.override_patch_stride(models[0], 7)
    jax_vit.override_patch_stride(models[1], 7)
    x = torch.zeros(1, 1 + 5 * 7, dim)
    pe, ref = (m.interpolate_pos_encoding(x, 42, 56)[:, 1:] for m in models)
    assert torch.equal(pe, ref)
    grid = models[0].pos_embed[:, 1:].reshape(1, side, side, dim).permute(0, 3, 1, 2)

    def laid_out(rows, cols):
        g = F.interpolate(grid, scale_factor=((rows + 0.1) / side, (cols + 0.1) / side),
                          mode="bicubic", align_corners=False, recompute_scale_factor=False)
        assert g.shape[-2:] == (rows, cols)
        return g.permute(0, 2, 3, 1).reshape(1, rows * cols, dim)

    assert torch.equal(pe, laid_out(7, 5))
    assert not torch.allclose(pe, laid_out(5, 7))
