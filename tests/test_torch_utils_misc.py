"""The port's profiling and inspection helpers (dpot_tpu_torch/utils/
profiling.py, utils/inspection.py) on the CPU, mirroring the JAX package's
tests/test_utils_misc.py, with the counts held to the JAX package's for the
same model (its params carried over by `dpot_params_from_torch`). The
two-rank `check_replica_consistency` cases ride in tests/test_torch_ddp.py's
launch (tests/torch_dist_cases.py case_train)."""

import json
import os

import numpy as np
import pytest
import torch

from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu.utils.inspection import module_summary as jax_module_summary
from dpot_tpu.utils.profiling import count_parameters as jax_count_parameters
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.utils.inspection import (
    assert_shape,
    check_replica_consistency,
    module_summary,
    save_results,
)
from dpot_tpu_torch.utils.profiling import (
    AverageMeter,
    EpochTimer,
    count_parameters,
    fence,
    host_fetch,
    profiled_function,
    timing,
    trace,
)


def small_dpot(**kw):
    return build_model("DPOT", device="cpu", seed=0, img_size=16, patch_size=4,
                       in_channels=2, in_timesteps=4, embed_dim=16, depth=2, n_blocks=2,
                       modes=4, **{"n_cls": 3, **kw})


def test_assert_shape():
    assert_shape(torch.zeros(2, 3, 4), (2, None, 4))
    with pytest.raises(AssertionError, match="dim 1"):
        assert_shape(torch.zeros(2, 3), (2, 4))
    with pytest.raises(AssertionError, match="wrong rank"):
        assert_shape(torch.zeros(2, 3), (2, 3, 1))


@pytest.mark.parametrize("kw", [{}, dict(normalize=True)])
def test_counts_equal_jax_s_for_the_same_model(kw):
    """count_parameters and module_summary's total against JAX's on the
    same weights; a complex tensor counts twice."""
    model = small_dpot(**kw)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jparams = dpot_params_from_torch(sd, depth=2, normalize=bool(kw))
    n = count_parameters(model)
    assert n == jax_count_parameters(jparams) == count_parameters(dict(model.named_parameters()))

    def total(s):
        return int(s.splitlines()[-1].split()[-1].replace(",", ""))

    s = module_summary(model)
    assert total(s) == total(jax_module_summary(jparams)) == n
    assert "blocks.0.filter.w1" in s and "TOTAL" in s
    assert total(module_summary(model, max_rows=3)) == n
    assert count_parameters({"a": torch.zeros(4, 8), "c": torch.zeros(3, dtype=torch.complex64)}) \
        == 32 + 6


def test_save_results(tmp_path):
    p = str(tmp_path / "r.csv")
    save_results(p, [{"ds": "a", "l2": 0.1}, {"ds": "b", "l2": 0.2}])
    txt = open(p).read()
    assert "ds,l2" in txt and "b,0.2" in txt
    save_results(str(tmp_path / "none.csv"), [])
    assert not os.path.exists(tmp_path / "none.csv")


def test_meters():
    m = AverageMeter()
    m.update(1.0)
    m.update(3.0, n=3)
    assert m.avg == 2.5 and m.val == 3.0 and m.count == 4
    t = EpochTimer()
    t.tick("load")
    t.tick("train")
    assert t.get("load") >= 0 and t.get("train") >= 0 and t.get("test") == 0.0


def test_fence_host_fetch_and_timing(capsys):
    x = torch.arange(6.0).reshape(2, 3) + 2
    assert fence(x) == 2.0
    tree = {"a": x, "b": [x[0], 7], "c": "s"}
    got = host_fetch(tree)
    x.add_(1)  # an in-place update after the fetch leaves the copies alone
    assert got["a"][0, 0] == 2.0 and got["b"][0][0] == 2.0
    assert got["b"][1] == 7 and got["c"] == "s"
    assert timing(lambda v: v * 2)(x).shape == (2, 3)
    assert "took" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    @profiled_function
    def dpot_annotated_step(v):
        return (v @ v).sum()

    with trace(str(tmp_path / "prof")) as prof:
        dpot_annotated_step(torch.ones(8, 8))
    path = prof.trace_file
    assert path and os.path.dirname(path) == str(tmp_path / "prof")
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "dpot_annotated_step" for e in events)


def test_replica_consistency_in_one_process():
    """One process has no replicas to compare (as JAX skips an array of one
    shard)."""
    assert check_replica_consistency(small_dpot()) == 0
    assert check_replica_consistency([torch.ones(2)], atol=1e-3) == 0
    assert np.isfinite(fence(torch.ones(1)))
