"""The port's sweep CLI (dpot_tpu_torch/cli/sweep.py) and its job expansion
(dpot_tpu_torch/utils/config.py expand_tasks) against the JAX package's,
over every file in configs/, and its runs on the CPU: in-process, as
subprocesses, and the scripts it does not have."""

import contextlib
import io
from pathlib import Path

import pytest
import torch
import yaml

from dpot_tpu.cli.sweep import job_to_argv as jax_job_to_argv
from dpot_tpu.utils.config import expand_tasks as jax_expand_tasks
from dpot_tpu_torch.cli import sweep
from dpot_tpu_torch.train.loop import check_ported
from dpot_tpu_torch.utils.config import expand_tasks, load_config

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
TRAIN_CONFIGS = [p for p in CONFIGS
                 if yaml.safe_load(p.read_text()).get("script") == "dpot_tpu.cli.train"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load(path):
    return yaml.safe_load(Path(path).read_text())


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_jobs_are_the_jax_sweeps(path):
    """The same jobs, in the same order, and the same flags for each."""
    jobs, want = expand_tasks(load(path)), jax_expand_tasks(load(path))
    assert jobs == want and len(jobs) >= 1
    assert [sweep.job_to_argv(j) for j in jobs] == [jax_job_to_argv(j) for j in want]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_dry_run_lists_the_ports_scripts(path):
    """--dry_run prints one line per job, naming the port's CLI in place of
    the JAX package's."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jobs = sweep.main(["--config_file", str(path), "--dry_run"])
    lines = out.getvalue().splitlines()[1:]
    name = load(path)["script"].rsplit(".", 1)[1]
    assert len(lines) == len(jobs)
    assert all(line.startswith(f"dpot_tpu_torch.cli.{name} --") for line in lines)


def test_dry_run_of_pretrain_large_lists_the_l_job_with_remat():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sweep.main(["--config_file", str(ROOT / "configs/pretrain_large.yaml"), "--dry_run"])
    (line,) = out.getvalue().splitlines()[1:]
    for flag in ("--remat true", "--width 1536", "--n_layers 24", "--n_blocks 16",
                 "--opt lamb", "--dtype bfloat16", "--batch_size 16"):
        assert flag in line, flag


@pytest.mark.parametrize("path", TRAIN_CONFIGS, ids=lambda p: p.name)
def test_every_train_job_in_configs_passes_check_ported(path):
    """Each job of every file that names the train CLI parses into a
    TrainConfig that the port's loop takes (remat included)."""
    for job in expand_tasks(load(path)):
        cfg = load_config(sweep.job_to_argv(job))
        check_ported(cfg)
        assert cfg.remat == bool(job.get("remat", False))


def tiny_yaml(tmp_path, **tasks):
    """A sweep file on an in-memory synthetic set at a tiny size, with
    remat on and the JAX package's train CLI named as in configs/."""
    doc = {
        "script": "dpot_tpu.cli.train", "model": "DPOT", "use_writer": True, "opt": "lamb",
        "remat": True, "train_paths": ["synthetic_sweep"], "ntrain_list": [2],
        "log_path": str(tmp_path / "logs"),
        "tasks": {"res": [16], "patch_size": [4], "width": [32], "n_layers": [2],
                  "n_blocks": [4], "modes": [4], "T_in": [4], "batch_size": [8],
                  "epochs": [1], "warmup_epochs": [1], "num_workers": [1], **tasks},
    }
    path = tmp_path / "sweep.yaml"
    path.write_text(yaml.safe_dump(doc))
    return path


def test_in_process_sweep_trains_each_job_with_remat(tmp_path):
    """Two jobs (an lr axis) run one after the other in this process, on the
    device given: each trains with remat on, finite losses."""
    path = tiny_yaml(tmp_path, lr=[1e-3, 5e-4])
    outs = sweep.main(["--config_file", str(path), "--device", "cpu"])
    assert len(outs) == 2
    for out, lr in zip(outs, (1e-3, 5e-4)):
        assert out["model"].remat and out["state"].step >= 1
        assert out["state"].optimizer.lr_at(0) <= lr
        assert torch.isfinite(torch.tensor(out["train_l2_step"]))
    assert len(list((tmp_path / "logs").iterdir())) == 2


def test_sweep_jobs_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.main(["--config_file", str(tiny_yaml(tmp_path))])


def test_a_failed_subprocess_job_fails_the_sweep(tmp_path):
    """Under --parallel 2 one job fails (an invalid moment dtype) and the
    other trains: the sweep runs both and exits non-zero, naming 1 of 2."""
    path = tiny_yaml(tmp_path, opt_moment_dtype=["float32", "float8"])
    with pytest.raises(SystemExit) as e:
        sweep.main(["--config_file", str(path), "--parallel", "2", "--device", "cpu"])
    assert "1/2 sweep jobs failed" in str(e.value.code)
    assert "float8" in str(e.value.code)
    (run,) = (tmp_path / "logs").iterdir()
    assert (run / "model" / "model.pth").is_file()


@pytest.mark.parametrize("script,error,match", [
    ("dpot_tpu.cli.sweep", ValueError, "a sweep runs one of"),
    ("dpot_tpu_torch.cli.train", ValueError, "a sweep runs one of"),
])
def test_scripts_the_port_does_not_have_raise(tmp_path, script, error, match):
    path = tmp_path / "s.yaml"
    path.write_text(yaml.safe_dump({"script": script, "tasks": {"epochs": [1]}}))
    with pytest.raises(error, match=match):
        sweep.main(["--config_file", str(path), "--dry_run"])


@pytest.mark.parametrize("script", ["dpot_tpu.cli.train", "dpot_tpu.cli.evaluate",
                                    "dpot_tpu.cli.finetune", "dpot_tpu.cli.finetune3d",
                                    "dpot_tpu.cli.convert", "dpot_tpu.cli.serve"])
def test_scripts_map_to_the_ports_clis(script):
    mod = sweep.port_script(script)
    assert mod == "dpot_tpu_torch.cli." + script.rsplit(".", 1)[1]
    __import__(mod)
