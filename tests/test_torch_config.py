"""The port's SVIConfig is a copy of the reference's: the same fields,
defaults, validation and helpers, and a config serialized by either
package loads in the other (CPU)."""

import dataclasses

import pytest

from terastructure_tpu.config import SVIConfig as RefSVIConfig
from terastructure_tpu_torch.config import SVIConfig


def _fields(cls):
    return [(f.name, f.default, f.type) for f in dataclasses.fields(cls)]


def test_same_fields_defaults_and_order():
    assert _fields(SVIConfig) == _fields(RefSVIConfig)
    assert SVIConfig() == SVIConfig(**dataclasses.asdict(RefSVIConfig()))


def test_frozen_and_hashable():
    cfg = SVIConfig(n=10, l=20, k=3)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.k = 4
    assert hash(cfg) == hash(SVIConfig(n=10, l=20, k=3))
    assert cfg.replace(k=4).k == 4 and cfg.k == 3


@pytest.mark.parametrize("bad", [
    dict(k=0), dict(k=-2), dict(batch_size=0), dict(gamma_psum_dtype="f16"),
])
def test_same_validation_errors(bad):
    with pytest.raises(ValueError) as want:
        RefSVIConfig(**bad)
    with pytest.raises(ValueError) as got:
        SVIConfig(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(n=940, l=640_000, k=7, batch_size=1024, snp_group=8),
    dict(n=2504, l=1_000_000, k=8, alpha=0.2, lambda_mode="stored",
         label="tgp"),
])
def test_json_round_trip_across_packages(kw):
    ours, ref = SVIConfig(**kw), RefSVIConfig(**kw)
    assert ours.to_json() == ref.to_json()
    assert SVIConfig.from_json(ref.to_json()) == ours
    assert RefSVIConfig.from_json(ours.to_json()) == ref


@pytest.mark.parametrize("t", [0, 1, 37.5, 10_000])
def test_same_derived_values(t):
    kw = dict(n=12, l=34, k=5, tau0=2.0, kappa=0.7, label="x")
    ours, ref = SVIConfig(**kw), RefSVIConfig(**kw)
    assert ours.alpha_value == ref.alpha_value == 0.2
    assert ours.rho(t) == ref.rho(t)
    assert ours.run_dir_name() == ref.run_dir_name() == "n12-k5-l34-x"


def test_make_run_dir(tmp_path):
    cfg = SVIConfig(n=1, l=2, k=3)
    path = cfg.make_run_dir(str(tmp_path))
    assert path == str(tmp_path / "n1-k3-l2-run")
    assert (tmp_path / "n1-k3-l2-run").is_dir()
