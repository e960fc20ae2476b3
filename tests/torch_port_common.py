"""Shared pieces of the `test_torch_*.py` parity tests: the small ViT-H
detection config, seeded inputs and a perturbed JAX parameter tree.

This module imports no JAX at import time, so the CUDA-only tests can use
it on a machine without JAX. Inputs and weights come from numpy
(`np.random.RandomState`) and go to both frameworks as arrays, so neither
framework's RNG is involved.
"""
import dataclasses

import numpy as np
import pytest

from uninext_tpu_torch.config import BackboneConfig, tiny_test_config


def tiny_vit_config():
    """tiny_test_config with the small ViT backbone of tests/test_model.py
    (embed 32, 2 blocks, 2 heads, window 4, block 1 global), fp32."""
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, backbone=BackboneConfig(
        name="vit_huge", vit_embed_dim=32, vit_depth=2, vit_num_heads=2,
        vit_window_size=4, vit_global_blocks=(1,), out_channels=(16, 32, 32),
        vit_flash_attn=False, vit_drop_path_rate=0.0))


def detection_inputs(seed=0, B=2, H=64, W=96, T=16):
    """Padded images (image 0 valid on 48 x 80), masks, sizes, prompt ids."""
    rng = np.random.RandomState(seed)
    images = rng.randn(B, H, W, 3).astype(np.float32)
    img_mask = np.zeros((B, H, W), bool)
    img_mask[0, 48:] = True
    img_mask[0, :, 80:] = True
    sizes = np.array([[48, 80], [H, W]][:B], np.int32)
    ids = rng.randint(0, 1000, (B, T)).astype(np.int32)
    tmask = np.zeros((B, T), np.int32)
    tmask[:, :10] = 1
    return images, img_mask, sizes, ids, tmask


# MSDA location sets: (geometry, level shapes). "tiny" has levels of 1x1 and
# 1x2 and odd widths; "edges" puts every coordinate on the frame's edges (0,
# 1), a pixel edge or a pixel centre, where grid_sample's rescaling through
# [-1, 1] may round to either side (continuous in the forward only).
MSDA_GEOMETRIES = ("uniform", "clustered", "tiny", "edges")
TINY_LEVELS = ((1, 1), (1, 2), (3, 5), (2, 7))


def msda_locations(rng, shapes, B, Lq, M, P, geometry, margin=0.0):
    """Sampling locations (B, Lq, M, L, P, 2), float32, of one geometry:
    "uniform" (and "tiny") in [-0.15, 1.15], a fifth of them out of frame;
    "clustered": the samples of each (image, head, level) within a 2 x 2
    pixel box at a random place (also across the frame's edge); "edges": on
    multiples of half a pixel. Each image draws its own. `margin` > 0 moves
    every location at least that many pixels off a pixel centre (bilinear
    sampling's kink, where gradients depend on rounding)."""
    L = len(shapes)
    loc = np.empty((B, Lq, M, L, P, 2), np.float32)
    for lvl, (H, W) in enumerate(shapes):
        size = np.array([W, H], np.float64)
        if geometry in ("uniform", "tiny"):
            px = rng.uniform(-0.15, 1.15, (B, Lq, M, P, 2)) * size - 0.5
        elif geometry == "clustered":
            corner = rng.randint(-1, size.astype(int), (B, 1, M, 1, 2))
            px = corner + rng.uniform(0, 2, (B, Lq, M, P, 2))
        elif geometry == "edges":
            half = rng.randint(0, 2 * size.astype(int) + 1, (B, Lq, M, P, 2))
            px = half / 2 - 0.5
        else:
            raise ValueError(geometry)
        if margin:
            frac = px - np.floor(px)
            px = np.where(frac < margin, px + margin,
                          np.where(frac > 1 - margin, px - margin, px))
        loc[:, :, :, lvl] = (px + 0.5) / size
    return loc


def perturb(params, seed=1, scale=0.05):
    """Add seeded noise to every leaf, so zero- and constant-initialised
    parameters (biases, rel-pos tables, offsets) carry information through
    the comparison. `up_res3/bias` stays four equal copies, the only form a
    ConvTranspose2d bias can take. The mask head's leaves (`controller`,
    `mask_head`) draw from a stream of their own, so the other leaves get
    the same noise whether or not the tree holds a mask head."""
    import jax      # imported here: the CUDA tests use this module without JAX

    main, heads = np.random.RandomState(seed), np.random.RandomState(seed + 1000)

    def one(path, x):
        x = np.asarray(x, np.float32)
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        rng = heads if name.startswith(("params/controller", "params/mask_head")) else main
        if name.endswith("up_res3/bias"):
            return np.tile(rng.randn(x.shape[0] // 4).astype(np.float32) * scale, 4)
        return x + rng.randn(*x.shape).astype(np.float32) * scale

    return jax.tree_util.tree_map_with_path(one, params)


def class_token_map(C=5, T=16):
    """(C, T) bool: class c's prompt tokens, 1 or 2 of them, from token 1."""
    m = np.zeros((C, T), bool)
    for c in range(C):
        m[c, 1 + 2 * c: 2 + 2 * c + (c % 2)] = True     # 1 or 2 tokens each
    return m


class FakeMesh:
    """A model group of k ranks seen from rank `r`, with no process group:
    `parallel/sharding.py:shard_module` cuts without a collective."""

    def __init__(self, k, r):
        self.model_size, self.model_rank, self.model_group = k, r, None


def detection_targets(seed=0, B=2, G=20, T=16, n=(3, 8)):
    """Synthetic targets padded to G: per image n[0]..n[1]-1 valid boxes
    (cxcywh inside the image), each with one or two positive prompt tokens
    among the first 10. Returns numpy boxes (B, G, 4), valid (B, G),
    positive_map (B, G, T)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    pm = np.zeros((B, G, T), bool)
    for b in range(B):
        k = rng.randint(*n)
        boxes[b, :k, :2] = rng.uniform(0.25, 0.75, (k, 2))
        boxes[b, :k, 2:] = rng.uniform(0.05, 0.4, (k, 2))
        valid[b, :k] = True
        for i in range(k):
            t0 = rng.randint(1, 9)
            pm[b, i, t0:t0 + 1 + rng.randint(2)] = True
    return boxes, valid, pm


def patch_image(rng, H, W, noise=1.0):
    """(H, W, 3) in [0, 255]: flat colour patches of 16 to 40 pixels and a
    little noise, so that most of BoxInst's neighbours pass its 0.3 colour
    similarity threshold."""
    img = np.zeros((H, W, 3), np.float32)
    y = 0
    while y < H:
        dy = rng.randint(16, 41)
        x = 0
        while x < W:
            dx = rng.randint(16, 41)
            img[y:y + dy, x:x + dx] = rng.uniform(0, 255, 3)
            x += dx
        y += dy
    return np.clip(img + rng.randn(H, W, 3) * noise, 0, 255).astype(np.float32)


def boxinst_targets(seed, inputs, targets, step):
    """BoxInst's targets for `detection_inputs` and `detection_targets`:
    each valid box (cxcywh over its image's size) as a bitmask at the padded
    size, and the colour similarity of seeded patch images on each image's
    valid area. Returns {box_bitmasks, color_similarity, step} as numpy."""
    from uninext_tpu_torch.data import boxinst

    rng = np.random.RandomState(seed)
    B, H, W = inputs[0].shape[:3]
    sim = np.stack([boxinst.color_similarity(patch_image(rng, H, W),
                                             (~inputs[1][b]).astype(np.float32))
                    for b in range(B)])
    boxes, valid = targets[0], targets[1]
    bits = []
    for b in range(B):
        h, w = inputs[2][b]
        xyxy = np.concatenate([boxes[b, :, :2] - boxes[b, :, 2:] / 2,
                               boxes[b, :, :2] + boxes[b, :, 2:] / 2], -1) * [w, h, w, h]
        bits.append(boxinst.boxes_to_bitmasks(xyxy, valid[b], H, W))
    return {"box_bitmasks": np.stack(bits), "color_similarity": sim, "step": np.int32(step)}


def jax_train_init(jax_model, inputs, targets, seed=0):
    """Parameters of the JAX model initialised through its training path
    with mask targets (zeros), so the DN label encoder `dn_resizer` and the
    mask head (`controller`, `mask_head`) exist, as a tree of numpy
    arrays."""
    import jax

    boxes, valid, pm = targets
    B, H, W = inputs[0].shape[:3]
    masks = np.zeros((B, valid.shape[1], H // 4, W // 4), np.float32)
    tgt = {"boxes": boxes, "valid": valid, "positive_map": pm, "masks": masks,
           "has_masks": True}
    key = jax.random.PRNGKey(seed)
    params = jax.jit(lambda r: jax_model.init(
        {"params": r, "dn": jax.random.fold_in(r, 1)}, *inputs,
        targets=tgt, train=True))(key)
    return jax.tree.map(np.asarray, params)


def tiny_vit_init(tmp_path_factory, worker_id):
    """`jax_train_init` of `tiny_vit_config()` with key 0, once per session
    (`shared_across_workers`). Flax draws every parameter from the key and
    its module's path: the variants of `tiny_vit_config` that the tests use
    (other data and solver settings) and their inputs give this tree bit for
    bit, so their files share its one init compile."""
    from uninext_tpu.models.detr import UninextDETR

    return shared_across_workers("tiny_vit_init", lambda: jax_train_init(
        UninextDETR(tiny_vit_config()), detection_inputs(0), detection_targets(0)),
        tmp_path_factory, worker_id)


def init_statistics_match(got, want, min_extremes=4096):
    """Two trees of one layout (numpy leaves), `got` the port's random
    init carried over by the bridge's names and `want` JAX's `init`, held
    leaf by leaf: constant leaves equal; every other leaf of 16 or more
    entries has its mean within 6 standard errors of JAX's, its standard
    deviation within 0.8-1.25x (or 4 / sqrt(n) in the log for smaller
    leaves, where two sample deviations differ by about 1 / sqrt(n)); and
    with `min_extremes` or more entries its largest magnitude within
    0.85-1.18x of JAX's, which tells flax's truncated lecun-normal (no
    value beyond 2.27 standard deviations) from a normal. Returns the
    names of the leaves compared and of those whose extremes were."""
    import jax

    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    compared, extremes = [], []
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        name = jax.tree_util.keystr(path)
        g, w = np.asarray(got_leaves[path], np.float64), np.asarray(w, np.float64)
        if np.ptp(w) == 0:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        if w.size < 16:
            continue
        n = w.size
        assert abs(g.mean() - w.mean()) <= 6 * np.sqrt((g.var() + w.var()) / n) + 1e-7, \
            f"{name}: mean {g.mean():.4g} against {w.mean():.4g}"
        assert abs(np.log(g.std() / w.std())) < max(np.log(1.25), 4 / np.sqrt(n)), \
            f"{name}: std {g.std():.4g} against {w.std():.4g}"
        if n >= min_extremes:
            top = np.abs(g).max() / np.abs(w).max()
            assert 0.85 < top < 1.18, \
                f"{name}: largest |x| {np.abs(g).max():.4g} against {np.abs(w).max():.4g}"
            extremes.append(name)
        compared.append(name)
    return compared, extremes


def dn_noise(key, B, single_pad, groups=5):
    """(sign, part) as torch tensors, drawn from the JAX key `key` as
    `uninext_tpu/models/detr.py:prepare_dn_static` draws them."""
    import jax
    import jax.numpy as jnp
    import torch

    shape = (B, groups, 2, single_pad, 4)
    k_sign, k_part = jax.random.split(key)
    sign = jax.random.rademacher(k_sign, shape, dtype=jnp.float32)
    part = jax.random.uniform(k_part, shape)
    return torch.from_numpy(np.array(sign)), torch.from_numpy(np.array(part))


def jax_loss_and_grads(jm, params, inputs, targets, cfg, monkeypatch, dn_key,
                       task="detection", masks=None, boxinst=None):
    """jax.value_and_grad of the weighted total of `model.apply(...,
    train=True)` for `task`, with the mask losses when `masks` (B, G, H/4,
    W/4) is given, or BoxInst's when `boxinst` (a dict of `box_bitmasks`,
    `color_similarity` and `step`) is, and the DN key pinned to `dn_key`.
    The step compiles at XLA's backend optimisation level 0 (LLVM without
    optimisation), which takes less compile time than the default and
    gives these small steps' values within every caller's tolerance.
    Returns (total, losses, grads of params["params"])."""
    import jax

    import uninext_tpu.models.detr as jdetr
    from uninext_tpu.engine.train import loss_weights, weighted_total

    real = jdetr.prepare_dn_static

    def pinned(gt_boxes, gt_valid, label_enc, rng, box_noise_scale, **kw):
        return real(gt_boxes, gt_valid, label_enc, dn_key, box_noise_scale, **kw)

    monkeypatch.setattr(jdetr, "prepare_dn_static", pinned)
    boxes, valid, pm = targets
    tgt = {"boxes": boxes, "valid": valid, "positive_map": pm,
           "has_masks": masks is not None}
    if masks is not None:
        tgt["masks"] = masks
    if boxinst is not None:
        tgt.update(boxinst, has_masks=True)
    weights = loss_weights(cfg)

    def loss_fn(p):
        losses = jm.apply({"params": p}, *inputs, task=task, targets=tgt, train=True,
                          rngs={"dn": jax.random.PRNGKey(0)})
        return weighted_total(losses, weights), losses

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(params["params"]).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    (total, losses), grads = step(params["params"])
    return total, losses, grads


def bridge_sources(params):
    """{port key: the JAX leaf paths the bridge builds it from}, recorded
    by running `convert.fill_model` over the tree."""
    from uninext_tpu_torch.engine import convert

    lv = convert._Leaves(params)
    taken, sources = [], {}
    take = lv.take

    def recording_take(path):
        taken.append(path)
        return take(path)

    lv.take = recording_take

    class Recorder(dict):
        def __setitem__(self, key, value):
            sources[key] = list(taken)
            taken.clear()
            super().__setitem__(key, value)

    convert.fill_model(Recorder(), "", lv, "")
    return sources


def shared_across_workers(name, make, tmp_path_factory, worker_id):
    """`make()` once for the test session. A module-scoped fixture runs again
    on every pytest-xdist worker that takes one of its module's tests, and
    with it the JAX compiles behind it; here the first worker to ask pickles
    the value (numpy arrays, floats, configs) into the session's shared
    temporary directory, and the others wait for it and load it. `name`
    must name what `make` computes, arguments included."""
    import pickle

    if worker_id == "master":
        return make()
    from filelock import FileLock

    root = tmp_path_factory.getbasetemp().parent
    path = root / f"shared_{name}.pkl"
    with FileLock(str(root / f"shared_{name}.lock")):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = make()
        with open(path, "wb") as f:
            pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
        return value


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one intra-op thread for a module's tests, restored after.
    The tests run beside other pytest workers on the same cores, where
    torch's default of one thread per core made the small steps of the
    training-loop tests 50-80x slower than alone."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- ranks of the parallel tests ----------------------------------------------
# Module-level functions, so that `parallel/mesh.py:launch` can start them in
# new processes; they import no JAX.

def parallel_step_rank(device, cfg, k, state_path, batch, noise, out_dir):
    """One rank of a (n/k, k) mesh: the train state with the weights of the
    whole state dict at `state_path` (None: the seed-0 weights), cut with
    tensor parallelism when k > 1, one step on the rank's rows of `batch`
    with the rank's rows of the DN `noise` (None: the state's generator),
    then a checkpoint of step 1 in `out_dir`. Returns the step's losses and
    grad norm (the whole batch's), and the A′ and kernel-A calls."""
    import torch

    from uninext_tpu_torch.engine.checkpoint import CheckpointManager
    from uninext_tpu_torch.engine.train import build_train_state, loss_and_grads, loss_weights
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.parallel import comm, sharding
    from uninext_tpu_torch.parallel.mesh import create_mesh, shard_batch

    torch.set_num_threads(1)
    mesh = create_mesh(k)
    state = build_train_state(cfg, device, seed=0, mesh=mesh, tp=k > 1)
    if state_path is not None:
        whole = torch.load(state_path, weights_only=True)
        state.model.load_state_dict(sharding.cut_state_dict(state.model, whole, mesh))
    rows = shard_batch(batch, mesh)
    noise = None if noise is None else tuple(shard_batch(n, mesh) for n in noise)
    total, losses = loss_and_grads(state.model, rows, loss_weights(cfg), state.generator,
                                   dn_noise=noise, mesh=mesh)
    norm = state.optimizer.step()
    state.step += 1
    out = {"total_loss": total, **losses, "grad_norm": norm}
    out = dict(zip(out, (float(v) for v in comm.mean_over_data(list(out.values()), mesh))))
    CheckpointManager(out_dir).save(1, state)
    heads = {n: m.num_heads for n, m in state.model.named_modules()
             if isinstance(m, vit.Attention)}
    return {"metrics": out, "heads": heads, "mesh": (mesh.data_rank, mesh.model_rank)}
