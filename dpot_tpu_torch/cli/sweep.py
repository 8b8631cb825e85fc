"""Sweep runner of the port (port of dpot_tpu/cli/sweep.py, the reference's
trainer.py / parallel_trainer.py):

    python -m dpot_tpu_torch.cli.sweep --config_file configs/pretrain_large.yaml \
        [--parallel N] [--dry_run] [--device cpu]

Expands the YAML `tasks:` grid (every list is a grid axis) into jobs and runs
each with the CLI the file's `script:` names, in this process one after the
other, or as up to N subprocesses at a time with --parallel N. The files
name the JAX package's CLIs (`dpot_tpu.cli.train`); each runs as the port's
CLI of the same name (`dpot_tpu_torch.cli.train`). --device (cuda by
default, where the kernels run; cpu runs their plain versions) is passed to
every job. A job that fails makes the sweep fail: in-process its exception
propagates; a subprocess's exit code is kept and the sweep exits non-zero
after the others have run.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

JAX_CLI = "dpot_tpu.cli."
PORT_CLI = "dpot_tpu_torch.cli."
# the JAX package's CLIs that a sweep runs: all of them, in the port
PORTED = ("train", "finetune", "finetune3d", "evaluate", "convert", "serve")


def port_script(script: str) -> str:
    """The port's module for the JAX CLI module (`dpot_tpu.cli.<name>`) that
    a sweep file names, as a string: nothing of the JAX package is
    imported."""
    name = script[len(JAX_CLI):] if script.startswith(JAX_CLI) else None
    if name in PORTED:
        return PORT_CLI + name
    raise ValueError(f"a sweep runs one of the CLIs {[JAX_CLI + n for n in PORTED]}, "
                     f"not {script!r}")


def job_to_argv(job: dict) -> list[str]:
    """A job's keys as CLI flags: lists as several values, booleans as
    true/false ('script' and 'parallel' are the sweep's own)."""
    argv = []
    for k, v in job.items():
        if k in ("script", "parallel"):
            continue
        argv.append(f"--{k}")
        if isinstance(v, (list, tuple)):
            argv.extend(str(x) for x in v)
        elif isinstance(v, bool):
            argv.append(str(v).lower())
        else:
            argv.append(str(v))
    return argv


def main(argv=None) -> list:
    """Run the sweep. Returns the jobs (with --dry_run or --parallel N > 1)
    or what each in-process job's main returned, in the jobs' order."""
    import yaml

    from dpot_tpu_torch.utils.config import expand_tasks, pop_flag

    argv = list(argv if argv is not None else sys.argv[1:])
    device = pop_flag(argv, "--device", "cuda")
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", required=True)
    p.add_argument("--parallel", type=int, default=1,
                   help="max concurrent subprocesses (1 = in-process, sequential)")
    p.add_argument("--dry_run", action="store_true")
    ns = p.parse_args(argv)

    with open(ns.config_file) as f:
        y = yaml.safe_load(f)
    script = port_script(y.get("script", JAX_CLI + "train"))
    jobs = expand_tasks(y)
    print(f"{len(jobs)} job(s) expanded from {ns.config_file}", flush=True)

    if ns.dry_run:
        for j in jobs:
            print(script, " ".join(job_to_argv(j)))
        return jobs

    if ns.parallel <= 1:
        from importlib import import_module

        mod = import_module(script)
        results = []
        for i, j in enumerate(jobs):
            print(f"=== job {i + 1}/{len(jobs)} ===", flush=True)
            results.append(mod.main(job_to_argv(j) + ["--device", device]))
        return results

    procs: list[subprocess.Popen] = []
    failed: list[tuple[str, int]] = []
    queue = list(jobs)
    while queue or procs:
        # collect finished jobs, keeping their exit status: a crashed grid
        # point must not vanish from a sweep that exits 0
        still = []
        for pr in procs:
            rc = pr.poll()
            if rc is None:
                still.append(pr)
            elif rc != 0:
                print(f"FAILED (exit {rc}): {' '.join(pr.args)}", flush=True)
                failed.append((" ".join(pr.args), rc))
        procs = still
        while queue and len(procs) < ns.parallel:
            cmd = [sys.executable, "-m", script] + job_to_argv(queue.pop(0)) + [
                "--device", device]
            print("launch:", " ".join(cmd), flush=True)
            procs.append(subprocess.Popen(cmd))
        if procs:
            procs[0].wait()
    if failed:
        raise SystemExit(
            f"{len(failed)}/{len(jobs)} sweep jobs failed: "
            + "; ".join(f"exit {rc}: {c}" for c, rc in failed[:4])
        )
    return jobs


if __name__ == "__main__":
    main()
