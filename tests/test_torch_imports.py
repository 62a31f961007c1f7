"""The port stands alone, and its kernel wrappers hide no device.

- An AST scan: no file under dpm_solver_tpu_torch/ imports jax, flax or
  dpm_solver_tpu (a `sys.modules` check cannot show it: the test process
  imports jax anyway).
- On the CPU every wrapper takes its plain version and launches nothing:
  the launch counters stay at 0 through a whole tiny sampling run.
- The wrappers' input checks, which guard the CUDA launches, refuse what the
  kernels do not take (they run on tensors of any device).
"""

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

import dpm_solver_tpu_torch as P
from dpm_solver_tpu_torch import ops
from dpm_solver_tpu_torch.models import DDPMUNet, DDPMUNetConfig, init_random_

# the modules themselves: `ops` re-exports functions of the same names
attention, conv3x3, fused_update = (importlib.import_module(f"dpm_solver_tpu_torch.ops.{m}")
                                    for m in ("attention", "conv3x3", "fused_update"))

PKG = pathlib.Path(P.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dpm_solver_tpu")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_port_never_imports_jax(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(FORBIDDEN), f"{path} imports {roots & set(FORBIDDEN)}"


def test_cpu_run_takes_plain_path_and_launches_nothing():
    ops.reset_launch_counts()
    net = init_random_(DDPMUNet(DDPMUNetConfig.tiny(resolution=8)),
                       torch.Generator().manual_seed(0)).eval()
    ns = P.NoiseScheduleVP.discrete(betas=np.linspace(1e-4, 0.02, 1000))
    solver = P.DPM_Solver(P.model_wrapper(net, ns), ns, algorithm_type="dpmsolver++")
    with torch.no_grad():
        out = solver.sample(torch.randn(1, 8, 8, 3, generator=torch.Generator().manual_seed(1)),
                            steps=3, order=3, skip_type="logSNR", method="multistep")
    assert out.shape == (1, 8, 8, 3) and torch.isfinite(out).all()
    assert ops.launch_counts() == {"conv3x3": 0, "token_attention": 0, "fused_update": 0}


def test_conv3x3_checks_refuse_what_the_kernel_does_not_take():
    x, w, b = torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 16), torch.zeros(16)
    conv3x3._check(x, w, b)
    with pytest.raises(TypeError):
        conv3x3._check(x.half(), w.half(), b)
    with pytest.raises(TypeError):
        conv3x3._check(x, w.bfloat16(), b)
    with pytest.raises(ValueError):
        conv3x3._check(x.transpose(1, 2), w, b)          # not contiguous
    with pytest.raises(ValueError):
        conv3x3._check(x, torch.zeros(3, 3, 4, 16), b)   # channel mismatch
    with pytest.raises(ValueError):
        conv3x3._check(x, w, b.bfloat16())              # bias must be fp32
    with pytest.raises(ValueError):
        conv3x3._check(x, torch.zeros(1, 1, 8, 16), b)   # not 3x3


def test_attention_checks_refuse_what_the_kernel_does_not_take():
    q = torch.zeros(2, 16, 256)
    attention._check(q, q, q, 1)
    attention._check(q, q, q, 8)                         # dh = 32
    attention._check(q, q, q, 2)                         # dh = 128
    u = torch.zeros(2, 16, 80)
    with pytest.raises(ValueError):
        attention._check(u, u, u, 2)                     # dh = 40: not yet
    with pytest.raises(TypeError):
        attention._check(q.half(), q.half(), q.half(), 1)
    with pytest.raises(ValueError):
        attention._check(q, q[:, :0], q[:, :0], 1)       # no keys
    with pytest.raises(ValueError):
        attention._check(q[:, :, ::2].contiguous(), q, q, 1)
    qb = q.bfloat16()
    attention._check(qb, qb, qb, 1)
    shifted = torch.zeros(qb.numel() + 1, dtype=torch.bfloat16)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="aligned"):
        attention._check(shifted, qb, qb, 1)                 # 2-byte offset


def test_fused_update_checks_refuse_what_the_kernel_does_not_take():
    coef, x = torch.zeros(3, 8), torch.zeros(2, 5)
    fused_update._check(coef, 2, x, (x, x, x), x)
    with pytest.raises(IndexError):
        fused_update._check(coef, 3, x, (x, x, x), None)
    with pytest.raises(ValueError):
        fused_update._check(coef.double(), 0, x, (x, x, x), None)
    with pytest.raises(ValueError):
        fused_update._check(coef, 0, x.bfloat16(), (x, x, x), None)
    with pytest.raises(ValueError):
        fused_update._check(coef, 0, x, (x, x, torch.zeros(5, 2).t()), None)
    with pytest.raises(ValueError):
        fused_update._check(coef[:, ::2], 0, x, (x, x, x), None)  # 4 columns


def test_wrappers_refuse_other_devices():
    meta = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.conv3x3(meta, torch.zeros(3, 3, 8, 8, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.token_attention(meta[0], meta[0], meta[0], num_heads=1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.fused_update(torch.zeros(1, 8, device="meta"), 0, meta, meta, meta, meta)
