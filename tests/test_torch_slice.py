"""The whole detection slice of the port vs the JAX `UninextDETR`, on the
CPU: forward + `postprocess_detection` at a small size, the weight bridge's
round trip through `convert_checkpoint`, and the port's independence from
JAX and the JAX package.

Config: `tiny_test_config()` with the small ViT backbone of
tests/test_model.py (embed 32, 2 blocks, block 1 global with its rel-pos
table stored at span 127 and shrunk to 7 and 11), fp32.
"""
import copy
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_common import (detection_inputs, detection_targets,
                                     jax_train_init, perturb, tiny_vit_config)
from uninext_tpu.engine.convert import convert_checkpoint
from uninext_tpu.models.detr import UninextDETR as JaxDETR
from uninext_tpu.models.postprocess import postprocess_detection as jax_post
from uninext_tpu_torch.engine.convert import load_jax_params
from uninext_tpu_torch.models.detr import build_model
from uninext_tpu_torch.models.postprocess import postprocess_detection

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_vit_config()
    inputs = detection_inputs(0)
    jm = JaxDETR(cfg)
    # initialised through the training path, so the tree also holds the DN
    # label encoder (`dn_resizer`), which the port's model has
    params = perturb(jax_train_init(jm, inputs, detection_targets(0)))
    model = build_model(cfg, "cpu", seed=0)
    load_jax_params(model, params)
    return cfg, inputs, jm, params, model


def _class_token_map(C=5, T=16):
    m = np.zeros((C, T), bool)
    for c in range(C):
        m[c, 1 + 2 * c: 2 + 2 * c + (c % 2)] = True     # 1 or 2 tokens each
    return m


def test_detection_forward_and_postprocess_match_jax(pair):
    cfg, inputs, jm, params, model = pair
    want = jax.jit(lambda p: jm.apply(p, *inputs))(params)
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in inputs))
    for key in ("pred_logits", "pred_boxes", "pred_boxious"):
        assert got[key].shape == want[key].shape, key
        # fp32 through backbone, BERT, 2 + 2 transformer layers and heads
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)
    cmap = _class_token_map()
    jpost = jax.jit(lambda o: jax_post(o, cmap))(
        {k: want[k] for k in ("pred_logits", "pred_boxes", "pred_boxious")})
    with torch.inference_mode():
        post = postprocess_detection(got, torch.from_numpy(cmap))
    np.testing.assert_array_equal(post["query_idx"].numpy(),
                                  np.asarray(jpost["query_idx"]))
    np.testing.assert_array_equal(post["classes"].numpy(),
                                  np.asarray(jpost["classes"]))
    for key in ("boxes", "scores"):
        # same selections of values that agree to ~1e-6
        np.testing.assert_allclose(post[key].numpy(), np.asarray(jpost[key]),
                                   atol=1e-5, err_msg=key)


def test_bridge_round_trip_through_convert_checkpoint(pair):
    """JAX tree -> port (load_jax_params) -> port.state_dict() ->
    convert_checkpoint onto a zeroed tree gives back every JAX leaf
    exactly, with nothing missing, mismatched or unused."""
    cfg, inputs, jm, params, model = pair
    zeroed = jax.tree.map(np.zeros_like, params)
    back, report = convert_checkpoint(model.state_dict(), copy.deepcopy(zeroed))
    assert report["missing_target"] == []
    assert report["shape_mismatch"] == []
    assert report["unused_source"] == []
    # the template is zeroed: a leaf the port's state_dict did not fill would
    # come back as zeros, not as the perturbed value
    leaves = jax.tree_util.tree_leaves_with_path(params)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(back_leaves[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_port_runs_without_jax():
    """Importing the port, serving a request and taking a train step leave
    jax, flax and the JAX package (`uninext_tpu`, `uninext_tpu.*`) out of
    sys.modules: the H100 machine runs the port without them."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import uninext_tpu_torch
        from uninext_tpu_torch.config import BackboneConfig, tiny_test_config
        from uninext_tpu_torch.data.coco_categories import COCO_CATEGORIES
        from uninext_tpu_torch.data.prompts import create_label_token_map
        from uninext_tpu_torch.data.tokenizer import BertTokenizer
        from uninext_tpu_torch.engine.train import build_train_state, train_step
        from uninext_tpu_torch.models.detr import build_model
        from uninext_tpu_torch.models.postprocess import postprocess_detection
        import dataclasses
        cfg = dataclasses.replace(tiny_test_config(), backbone=BackboneConfig(
            name="vit_huge", vit_embed_dim=32, vit_depth=2, vit_num_heads=2,
            vit_window_size=4, vit_global_blocks=(1,), out_channels=(16, 32, 32)))
        p_ids, p_mask, cmap = create_label_token_map(COCO_CATEGORIES[:3],
                                                     BertTokenizer(), 16)
        model = build_model(cfg, "cpu", seed=3)
        rng = np.random.RandomState(1)
        images = torch.from_numpy(rng.randn(2, 64, 96, 3).astype(np.float32))
        img_mask = torch.zeros(2, 64, 96, dtype=torch.bool)
        img_mask[0, 48:] = True
        sizes = torch.tensor([[48, 96], [64, 96]])
        ids = torch.from_numpy(rng.randint(0, 1000, (2, 16)))
        tmask = torch.ones(2, 16, dtype=torch.int32)
        with torch.inference_mode():
            out = model(images, img_mask, sizes, ids, tmask)
            post = postprocess_detection(out, torch.eye(16, dtype=torch.bool)[:5])
        assert torch.isfinite(out["pred_logits"]).all()
        assert post["boxes"].shape == (2, 100, 4)
        state = build_train_state(cfg, "cpu", seed=3)
        G = cfg.data.max_insts                 # targets padded to max_insts
        boxes = torch.zeros(2, G, 4)
        boxes[:, 0] = torch.tensor([0.5, 0.5, 0.2, 0.3])
        valid = torch.zeros(2, G, dtype=torch.bool)
        valid[:, 0] = True
        pmap = torch.zeros(2, G, 16, dtype=torch.bool)
        pmap[:, 0] = torch.from_numpy(cmap[0])
        targets = {"boxes": boxes, "valid": valid, "positive_map": pmap}
        metrics = train_step(state, {"images": images, "img_mask": img_mask,
                                     "image_sizes": sizes,
                                     "text_ids": torch.from_numpy(p_ids).long()[None].expand(2, 16),
                                     "text_mask": torch.from_numpy(p_mask)[None].expand(2, 16),
                                     "targets": targets})
        assert torch.isfinite(metrics["total_loss"])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "uninext_tpu"))
        print("JAX_MODULES", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_MODULES []" in proc.stdout, proc.stdout
