"""The port's copy of the configuration (`uninext_tpu_torch/config.py`)
agrees with `uninext_tpu/config.py` field by field, for every preset the
port has: the port reads its own copy, so a change on one side shows
here."""
import dataclasses

import pytest

import uninext_tpu.config as jcfg
import uninext_tpu_torch.config as tcfg


@pytest.mark.parametrize("preset", ["image_joint_r50", "image_joint_vit_huge",
                                    "tiny_test_config", "UninextConfig"])
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
