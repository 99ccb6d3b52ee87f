"""The port's command line (terastructure_tpu_torch/cli.py) with
--force-cpu, mirroring the reference's CLI tests (tests/test_io_cli.py)
and holding the port's run directory against the reference CLI's on the
same argv: config.json and the simulator's files byte for byte, the same
run-directory name, a reference run directory read back (`load_model`,
`fit --init-model`), and a resume through the CLI bitwise an
uninterrupted fit (gamma.txt, and in the stored mode lambda.txt, byte
for byte). Without a CUDA card and without --force-cpu the CLI exits
non-zero, naming the missing card."""

import json
import os
import subprocess
import sys
import unittest.mock as mock
from pathlib import Path

import numpy as np
import pytest

from terastructure_tpu import cli as ref_cli
from terastructure_tpu_torch import cli
from terastructure_tpu_torch.io.export import load_matrix, load_model

ROOT = Path(__file__).resolve().parents[1]
FIT = ["--batch-size", "32", "--rfreq", "50", "--seed", "3", "--force-cpu"]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference CLI's simulate and a 100-step fit (label "t")."""
    base = tmp_path_factory.mktemp("ref")
    stem = str(base / "sim" / "toy")
    ref_cli.main(["simulate", "-n", "48", "-l", "120", "-k", "2",
                  "--seed", "3", "-o", stem])
    ref_cli.main(["fit", "--bed", stem + ".bed", "-k", "2", "--max-steps",
                  "100", "--label", "t", "--out-base", str(base)] + FIT)
    return base, stem


def test_simulate_writes_the_references_files(tmp_path, ref_run):
    base, ref_stem = ref_run
    stem = str(tmp_path / "sim" / "toy")
    cli.main(["simulate", "-n", "48", "-l", "120", "-k", "2", "--seed", "3",
              "-o", stem])
    for ext in (".bed", ".fam", ".bim", ".theta_true.txt",
                ".beta_true.txt"):
        assert _read(stem + ext) == _read(ref_stem + ext), ext


def test_fit_run_dir_matches_the_references(tmp_path, ref_run):
    base, stem = ref_run
    cli.main(["fit", "--bed", stem + ".bed", "-k", "2", "--max-steps", "100",
              "--label", "t", "--out-base", str(tmp_path)] + FIT)
    ours, theirs = tmp_path / "n48-k2-l120-t", base / "n48-k2-l120-t"
    assert ours.is_dir() and theirs.is_dir()
    assert _read(ours / "config.json") == _read(theirs / "config.json")
    assert (sorted(p.name for p in ours.iterdir())
            == sorted(p.name for p in theirs.iterdir()))
    mine = [json.loads(s) for s in
            (ours / "metrics.jsonl").read_text().splitlines()]
    ref = [json.loads(s) for s in
           (theirs / "metrics.jsonl").read_text().splitlines()]
    assert [set(r) for r in mine] == [set(r) for r in ref]
    assert [r["step"] for r in mine] == [r["step"] for r in ref] == [50, 100]
    res = json.loads((ours / "result.json").read_text())
    assert set(res) == set(json.loads((theirs / "result.json").read_text())
                           ) | {"timings"}


def test_load_model_and_init_model_read_a_reference_run_dir(tmp_path,
                                                            ref_run):
    base, stem = ref_run
    ref_dir = base / "n48-k2-l120-t"
    gamma, lamb = load_model(str(ref_dir))
    assert gamma.shape == (48, 2) and lamb.shape == (120, 2, 2)
    # max-steps 0: no step, the run's gamma is the reference run's
    cli.main(["fit", "--bed", stem + ".bed", "-k", "2", "--max-steps", "0",
              "--label", "im", "--init-model", str(ref_dir),
              "--out-base", str(tmp_path)] + FIT)
    run = tmp_path / "n48-k2-l120-im"
    assert _read(run / "gamma.txt") == _read(ref_dir / "gamma.txt")
    assert "initialized from text model" in (run / "infer.log").read_text()


def test_cli_simulate_fit_computebeta_roundtrip(tmp_path):
    stem = str(tmp_path / "sim" / "toy")
    cli.main(["simulate", "-n", "48", "-l", "120", "-k", "2",
              "--seed", "3", "-o", stem])
    cli.main(["fit", "--bed", stem + ".bed", "-k", "2", "--max-steps", "400",
              "--label", "t", "--out-base", str(tmp_path)] + FIT)
    run_dir = tmp_path / "n48-k2-l120-t"
    for f in ("theta.txt", "gamma.txt", "beta.txt", "lambda.txt",
              "metrics.jsonl", "validation.txt", "infer.log", "config.json",
              "result.json", "checkpoint"):
        assert (run_dir / f).exists(), f
    theta = load_matrix(run_dir / "theta.txt")
    assert theta.shape == (48, 2)
    np.testing.assert_allclose(theta.sum(1), 1.0, rtol=1e-4)
    res = json.loads((run_dir / "result.json").read_text())
    assert np.isfinite(res["validation_ll"]) and res["steps"] <= 400
    assert set(res["timings"]) >= {"ingest_s", "chunk_s", "eval_s",
                                   "export_s", "write_s"}
    # compute-beta from the checkpoint: the same gamma through the same
    # lambda solve, the fit's beta.txt text for text
    fit_beta = _read(run_dir / "beta.txt")
    cli.main(["compute-beta", "--run-dir", str(run_dir),
              "--bed", stem + ".bed", "--force-cpu"])
    assert _read(run_dir / "beta.txt") == fit_beta
    beta = load_matrix(run_dir / "beta.txt")
    assert beta.shape == (120, 2) and ((beta > 0) & (beta < 1)).all()


@pytest.mark.parametrize("batched", [False, True])
def test_cli_replicates(tmp_path, batched):
    stem = str(tmp_path / "toy2")
    cli.main(["simulate", "-n", "24", "-l", "60", "-k", "2",
              "--seed", "5", "-o", stem])
    cli.main(["fit", "--bed", stem + ".bed", "-k", "2", "--replicates", "2",
              "--batch-size", "16", "--rfreq", "50", "--max-steps", "150",
              "--label", "reps", "--out-base", str(tmp_path), "--seed", "7",
              "--force-cpu"] + (["--batched"] if batched else []))
    run_dir = tmp_path / "n24-k2-l60-reps"
    best = json.loads((run_dir / "best.json").read_text())
    assert best["dir"] in ("replicate-s7", "replicate-s8")
    assert np.isfinite(best["heldout_ll"])      # not the reference's None
    assert (run_dir / best["dir"] / "theta.txt").exists()
    for s in (7, 8):
        assert (run_dir / f"replicate-s{s}" / "result.json").exists()


@pytest.mark.parametrize("lambda_mode", ["local", "stored"])
def test_cli_resume_is_bitwise(tmp_path, lambda_mode):
    stem = str(tmp_path / "toy3")
    cli.main(["simulate", "-n", "32", "-l", "96", "-k", "2",
              "--seed", "6", "-o", stem])
    common = ["fit", "--bed", stem + ".bed", "-k", "2", "--batch-size", "16",
              "--rfreq", "40", "--validation-frac", "0", "--heldout-frac",
              "0", "--out-base", str(tmp_path), "--seed", "6", "--force-cpu",
              "--lambda-mode", lambda_mode]
    cli.main(common + ["--label", "rz", "--max-steps", "80"])
    run_dir = tmp_path / "n32-k2-l96-rz"
    assert json.loads((run_dir / "result.json").read_text())["steps"] == 80
    cli.main(common + ["--label", "rz", "--max-steps", "160", "--resume"])
    assert json.loads((run_dir / "result.json").read_text())["steps"] == 160
    assert "resuming from step 80" in (run_dir / "infer.log").read_text()
    cli.main(common + ["--label", "straight", "--max-steps", "160"])
    straight = tmp_path / "n32-k2-l96-straight"
    assert _read(run_dir / "gamma.txt") == _read(straight / "gamma.txt")
    assert _read(run_dir / "lambda.txt") == _read(straight / "lambda.txt")
    steps = [json.loads(s)["step"] for s in
             (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert steps == [40, 80, 120, 160]


def test_cli_resume_continues_the_validation_trace(tmp_path):
    stem = str(tmp_path / "toy3")
    cli.main(["simulate", "-n", "32", "-l", "96", "-k", "2",
              "--seed", "6", "-o", stem])
    common = ["fit", "--bed", stem + ".bed", "-k", "2",
              "--batch-size", "16", "--rfreq", "40",
              "--label", "rz", "--out-base", str(tmp_path), "--seed", "6",
              "--force-cpu"]
    cli.main(common + ["--max-steps", "80"])
    run_dir = tmp_path / "n32-k2-l96-rz"
    cli.main(common + ["--max-steps", "160", "--resume"])
    lines = (run_dir / "validation.txt").read_text().strip().splitlines()
    steps = [int(s.split("\t")[0]) for s in lines]
    assert 80 in steps and max(steps) <= 160


def test_legacy_flag_translation(tmp_path, monkeypatch):
    """Reference-binary command lines keep working."""
    stem = str(tmp_path / "lg")
    cli.main(["simulate", "-n", "24", "-l", "64", "-k", "2",
              "--seed", "8", "-o", stem])
    monkeypatch.chdir(tmp_path)
    captured = {}
    with mock.patch.object(cli, "cmd_fit", lambda a: captured.update(a=a)):
        cli.main(["-file", stem + ".bed", "-k", "2", "-label", "legacy",
                  "-rfreq", "40", "-seed", "8"])
    args = captured["a"]
    assert (args.bed, args.k, args.label, args.rfreq, args.seed) == (
        stem + ".bed", 2, "legacy", 40, 8)
    assert cli._translate_legacy(["-file", "g.bed", "-k", "3", "-idfile",
                                  "x.ids"]) == ref_cli._translate_legacy(
        ["-file", "g.bed", "-k", "3", "-idfile", "x.ids"])
    with pytest.raises(SystemExit):
        cli._translate_legacy(["-file", "g.bed", "-k", "3",
                               "-compute-beta"])


def test_idfile_overrides_output_labels(tmp_path):
    base = tmp_path / "toy"
    cli.main(["simulate", "-n", "12", "-l", "40", "-k", "2",
              "-o", str(base)])
    ids = tmp_path / "ids.txt"
    ids.write_text("".join(f"SAMPLE{i}\n" for i in range(12)))
    cli.main(["fit", "--bed", str(base) + ".bed", "-k", "2",
              "--idfile", str(ids), "--force-cpu", "--max-steps", "100",
              "--rfreq", "50", "--out-base", str(tmp_path)])
    theta = (tmp_path / "n12-k2-l40-run" / "theta.txt").read_text()
    assert "SAMPLE0" in theta and "SAMPLE11" in theta


def _parse(mod, argv):
    captured = {}
    with mock.patch.object(mod, "cmd_fit", lambda a: captured.update(a=a)):
        mod.main(argv)
    return captured["a"]


@pytest.mark.parametrize("flags", [
    ["--fast"], [], ["--fast", "--local-iters", "12"],
    ["--local-iters", "12", "--accel"], ["--no-accel", "--local-iters", "16"],
    ["--no-accel"], ["--local-iters", "2", "--accel"],
    ["--gamma-psum-dtype", "bf16", "--compute-dtype", "bfloat16",
     "--lambda-mode", "stored", "--init-mode", "spectral", "--kappa", "0.7"],
    ["--ind-shards", "2"], ["--snp-shards", "4"],
    ["--gamma-psum-dtype", "bf16"],
])
def test_flags_map_to_the_references_config(flags):
    """Each flag set gives the reference's SVIConfig (the accel pairing,
    --fast, the grid's axes, the rest), compared as its JSON."""
    argv = ["fit", "--simulate", "-n", "64", "-l", "128", "-k", "2"] + flags
    ours = cli._cfg_from_args(_parse(cli, argv), 64, 128)
    ref = ref_cli._cfg_from_args(_parse(ref_cli, argv), 64, 128)
    assert ours.to_json() == ref.to_json()


@pytest.mark.parametrize("flag", ["--ind-shards", "--snp-shards"])
def test_a_grid_larger_than_the_world_exits(tmp_path, flag):
    """fit --ind-shards 2 (or --snp-shards 2) in a world of one rank exits
    non-zero naming the world size, as the reference's choose_mesh_shape
    refuses a mesh that does not fit its devices."""
    with pytest.raises(SystemExit, match="world size 1"):
        cli.main(["fit", "--simulate", "-n", "16", "-l", "32", "-k", "2",
                  flag, "2", "--max-steps", "10", "--out-base",
                  str(tmp_path), "--force-cpu"])


def test_cli_validate_prints_the_references_keys(capsys):
    """`validate` runs SVI and NUTS on the simulated matrix and prints one
    JSON line with the reference's keys (terastructure_tpu/cli.py:597-605:
    the summary per constrained parameter with several chains)."""
    cli.main(["validate", "--simulate", "-n", "16", "-l", "48", "-k", "2",
              "--n-samples", "30", "--n-warmup", "30", "--chains", "2",
              "--force-cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"theta_mae", "beta_mae", "svi_steps", "sampler",
                        "convergence"}
    assert out["sampler"] == "nuts" and out["svi_steps"] > 0
    assert set(out["convergence"]) == {"theta", "beta"}
    for v in out["convergence"].values():
        assert set(v) == {"max_rhat", "max_rank_rhat", "min_ess"}


def test_unknown_flags_are_refused_outside_validate():
    """Every subcommand, validate too since its port, refuses a flag it
    does not know, as argparse does; here `pca` one of validate's."""
    with pytest.raises(SystemExit) as e:
        cli.main(["pca", "--simulate", "-n", "16", "-l", "32",
                  "--sampler", "nuts", "--force-cpu"])
    assert e.value.code == 2


def test_without_force_cpu_exits_naming_the_missing_card(tmp_path):
    import torch

    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as e:
        cli.main(["fit", "--simulate", "-n", "16", "-l", "32", "-k", "2",
                  "--out-base", str(tmp_path)])
    assert e.value.code != 0 and "no CUDA card" in str(e.value.code)
    # and as a module, with __main__ support
    proc = subprocess.run(
        [sys.executable, "-m", "terastructure_tpu_torch.cli", "pca",
         "--simulate", "-n", "16", "-l", "32"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr


def test_pca_subcommand_writes_components(tmp_path):
    stem = str(tmp_path / "p")
    cli.main(["simulate", "-n", "40", "-l", "200", "-k", "3", "-o", stem])
    out = str(tmp_path / "pcs.txt")
    cli.main(["pca", "--bed", stem + ".bed", "--components", "4",
              "--force-cpu", "-o", out])
    pcs = load_matrix(out)
    assert pcs.shape == (40, 4) and np.isfinite(pcs).all()
    assert open(out).readline().split("\t")[1] == "ind0"


def test_viz_and_plot_subcommand(tmp_path):
    pytest.importorskip("matplotlib")
    from terastructure_tpu_torch import viz
    from terastructure_tpu_torch.io.export import _write_matrix

    assert list(viz.sort_by_dominant(
        np.array([[0.9, 0.1], [0.2, 0.8], [0.6, 0.4]]))) == [0, 2, 1]
    theta = np.random.default_rng(0).dirichlet(np.ones(3), size=40)
    _write_matrix(str(tmp_path / "theta.txt"), theta)
    viz.main([str(tmp_path), "-o", str(tmp_path / "plot.png")])
    assert (tmp_path / "plot.png").stat().st_size > 1000
    cli.main(["plot", str(tmp_path), "-o", str(tmp_path / "p.png"),
              "--no-sort"])
    assert (tmp_path / "p.png").exists()


def test_console_script_is_declared():
    text = (ROOT / "pyproject.toml").read_text()
    assert ('terastructure-tpu-torch = "terastructure_tpu_torch.cli:main"'
            in text)
    assert os.path.exists(ROOT / "terastructure_tpu_torch" / "cli.py")
