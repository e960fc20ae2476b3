"""The port's copy of the configuration (`uninext_tpu_torch/config.py`)
agrees with `uninext_tpu/config.py` field by field, for every preset the
port has: the port reads its own copy, so a change on one side shows
here."""
import dataclasses

import pytest

import uninext_tpu.config as jcfg
import uninext_tpu_torch.config as tcfg


@pytest.mark.parametrize("preset", ["image_joint_r50", "image_joint_vit_huge",
                                    "video_joint_r50", "video_joint_vit_huge",
                                    "image_joint_convnext_large",
                                    "video_joint_convnext_large", "roberta_base_language",
                                    "tiny_test_config",
                                    "tiny_video_test_config", "UninextConfig"])
def test_preset_matches_jax_field_by_field(preset):
    got = dataclasses.asdict(getattr(tcfg, preset)())
    want = dataclasses.asdict(getattr(jcfg, preset)())
    assert got == want


def test_dataclasses_have_the_same_fields():
    for name in ("BackboneConfig", "LanguageConfig", "TransformerConfig",
                 "MaskHeadConfig", "LossConfig", "SotConfig", "TrackConfig",
                 "DataConfig", "SolverConfig", "ParallelConfig", "UninextConfig"):
        got = [(f.name, f.type) for f in dataclasses.fields(getattr(tcfg, name))]
        want = [(f.name, f.type) for f in dataclasses.fields(getattr(jcfg, name))]
        assert got == want, name


@pytest.mark.parametrize("task", sorted(jcfg.EVAL_PRESETS))
def test_eval_presets_match_jax(task):
    """`EVAL_PRESETS` and what `eval_config` makes of `video_joint_r50`."""
    assert tcfg.EVAL_PRESETS[task] == jcfg.EVAL_PRESETS[task]
    got = tcfg.eval_config(tcfg.video_joint_r50(), task)
    want = jcfg.eval_config(jcfg.video_joint_r50(), task)
    assert (dataclasses.asdict(got[0]), got[1:]) == (dataclasses.asdict(want[0]), want[1:])


@pytest.mark.parametrize("flagship", [False, True])
def test_vis_fixture_config_matches_the_jax_tool(flagship):
    """`tools/vis_check.py:build_cfg` is `tools/_evidence_common.py:
    build_tiny_cfg(steps, frame_range=5, use_reid=True)`, or with
    `flagship` `tools/real_vis_check.py:flagship_cfg(steps)`."""
    import importlib.util
    import os
    import sys
    from uninext_tpu_torch.tools import vis_check
    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "tools")
    sys.path.insert(0, tools)
    try:
        if flagship:
            spec = importlib.util.spec_from_file_location(
                "real_vis_check", os.path.join(tools, "real_vis_check.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            want = mod.flagship_cfg(1000)
        else:
            from _evidence_common import build_tiny_cfg
            want = build_tiny_cfg(1000, frame_range=5, use_reid=True)
    finally:
        sys.path.remove(tools)
    assert dataclasses.asdict(vis_check.build_cfg(1000, flagship)) == dataclasses.asdict(want)


@pytest.mark.parametrize("flagship", [False, True])
def test_sot_fixture_config_matches_the_jax_tool(flagship):
    """`tools/sot_check.py:build_cfg` is `tools/_evidence_common.py:
    build_tiny_cfg(steps, frame_range=7)` (`tools/real_sot_check.py`'s);
    with `flagship`, `video_joint_r50` with the template branch and the
    settings of `tools/vis_check.py --flagship` at frame range 7."""
    import os
    import sys
    from uninext_tpu_torch.tools import sot_check, vis_check
    if flagship:
        got = sot_check.build_cfg(800, True)
        want = vis_check.build_cfg(800, True)
        assert got.sot.extra_backbone_for_template and got.sot.feature_fusion
        assert got.data.sampling_frame_range == 7
        assert dataclasses.asdict(dataclasses.replace(
            got, data=dataclasses.replace(got.data, sampling_frame_range=5))) == \
            dataclasses.asdict(dataclasses.replace(
                want, data=dataclasses.replace(want.data, sampling_frame_range=5)))
        return
    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "tools")
    sys.path.insert(0, tools)
    try:
        from _evidence_common import build_tiny_cfg
        want = build_tiny_cfg(800, frame_range=7)
    finally:
        sys.path.remove(tools)
    assert dataclasses.asdict(sot_check.build_cfg(800)) == dataclasses.asdict(want)


@pytest.mark.parametrize("tool", ["rec_check", "pipeline_check", "joint_check"])
def test_recipe_fixture_configs_match_the_jax_tools(tool):
    """The configs of the recipe's fixture tools against the JAX tools':
    `tools/rec_check.py:build_cfg` is `tools/real_rec_check.py:build_cfg`;
    `tools/pipeline_check.py:configs` are `tools/pipeline3_check.py`'s three
    stages (`build_tiny_cfg` and their replacements: BoxInst with its
    warm-up, the template backbone and the fuser); `tools/joint_check.py:
    build_cfg` is `tools/real_joint_check.py`'s `build_tiny_cfg(steps,
    frame_range=7, use_reid=True)`. `tools/evidence.py:build_tiny_cfg` is
    `tools/_evidence_common.py`'s at each use."""
    import importlib.util
    import os
    import sys
    from uninext_tpu_torch.tools import evidence, joint_check, pipeline_check, rec_check
    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "tools")
    sys.path.insert(0, tools)
    try:
        from _evidence_common import build_tiny_cfg
        if tool == "rec_check":
            spec = importlib.util.spec_from_file_location(
                "real_rec_check", os.path.join(tools, "real_rec_check.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            pairs = [(rec_check.build_cfg(1000), mod.build_cfg(1000))]
        elif tool == "pipeline_check":
            want1 = build_tiny_cfg(1200, min_size=224, max_size=352)
            want1 = dataclasses.replace(want1, loss=dataclasses.replace(
                want1.loss, boxinst=True, boxinst_warmup_iters=max(1200 // 6, 20)))
            want3 = build_tiny_cfg(600, frame_range=7, use_reid=True)
            want3 = dataclasses.replace(want3, sot=dataclasses.replace(
                want3.sot, extra_backbone_for_template=True, feature_fusion=True))
            wants = (want1, build_tiny_cfg(400, min_size=224, max_size=352), want3)
            pairs = list(zip(pipeline_check.configs(1200, 400, 600), wants))
            assert pairs[0][0].loss.boxinst_warmup_iters == 200
        else:
            pairs = [(joint_check.build_cfg(2500),
                      build_tiny_cfg(2500, frame_range=7, use_reid=True))]
        pairs += [(evidence.build_tiny_cfg(30, 224, 352, 3, True),
                   build_tiny_cfg(30, 224, 352, 3, True))]
    finally:
        sys.path.remove(tools)
    for got, want in pairs:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_convnext_fixture_config_matches_the_jax_tool():
    """`uninext_tpu_torch/tools/convnext_check.py:tiny_convnext_cfg` is
    `tools/convnext_check.py:tiny_convnext_cfg` (the path that file puts on
    `sys.path` is taken off again)."""
    import importlib.util
    import os
    import sys
    from uninext_tpu_torch.tools import convnext_check
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_convnext_check", os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "tools", "convnext_check.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        want = mod.tiny_convnext_cfg(1200)
    finally:
        sys.path[:] = path
    assert dataclasses.asdict(convnext_check.tiny_convnext_cfg(1200)) == dataclasses.asdict(want)
