"""The demos' notebooks, ported (dpm_solver_tpu_torch/examples/*.ipynb).

- `make_notebooks` writes the committed notebooks byte for byte;
- each has the JAX twin's cells (`examples/*.ipynb`, read as JSON): the
  same kinds in the same order, the same title and reference link;
- each asks for the card by default: no `--device cpu` in its ARGS, and with
  no card its run raises;
- each notebook's code cells, executed in one namespace on the CPU with
  `--device cpu` and a few steps added, write the files the demo writes
  (tests/test_torch_examples.py's list). The score_sde demo's PC loop
  (VPSDE's 1,000 steps) and bits/dim tolerance (1e-5) have no flag: here
  they run at 20 steps and 1e-2 (`_shallow_score_sde`).
"""

import json
from pathlib import Path

import pytest
import torch

from dpm_solver_tpu_torch.examples import make_notebooks

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(make_notebooks.HERE)
# the files each demo writes, and the few steps each CPU run takes
NOTEBOOKS = {
    "diffedit_inpaint.ipynb": (["--steps", "4"],
                               ["diffedit_original.png", "diffedit_edited.png",
                                "diffedit_mask.png"]),
    "score_sde_demo.ipynb": (["--batch", "2", "--steps", "4"], ["demo_pc.png", "demo_dpm.png"]),
    "latent_imagenet_diffusion.ipynb": (["--steps", "4"], ["demo_clscond.png"]),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def _shallow_score_sde(monkeypatch):
    """The score_sde demo's PC loop at 20 steps and its bits/dim ODE at
    rtol = atol = 1e-2 (the demo imports both inside its main)."""
    import dataclasses

    from dpm_solver_tpu_torch import likelihood, sde

    @dataclasses.dataclass(frozen=True)
    class ShallowVPSDE(sde.VPSDE):
        N: int = 20

    monkeypatch.setattr(sde, "VPSDE", ShallowVPSDE)
    orig = likelihood.get_likelihood_fn
    monkeypatch.setattr(likelihood, "get_likelihood_fn",
                        lambda *a, **k: orig(*a, **dict(k, rtol=1e-2, atol=1e-2)))


def _cells(path):
    return json.loads(Path(path).read_text())["cells"]


def test_the_table_is_the_jax_generators():
    assert set(NOTEBOOKS) == set(make_notebooks.NOTEBOOKS)
    assert set(NOTEBOOKS) == {p.name for p in (ROOT / "examples").glob("*.ipynb")}


def test_the_generator_writes_the_committed_notebooks(tmp_path):
    make_notebooks.main([str(tmp_path)])
    for name in NOTEBOOKS:
        assert (tmp_path / name).read_bytes() == (HERE / name).read_bytes(), name


@pytest.mark.parametrize("name", sorted(NOTEBOOKS))
def test_cells_match_the_jax_twin(name):
    ours, theirs = _cells(HERE / name), _cells(ROOT / "examples" / name)
    assert [c["cell_type"] for c in ours] == [c["cell_type"] for c in theirs]
    # the title and the reference link: the introduction's first three lines
    assert ours[0]["source"][:3] == theirs[0]["source"][:3]
    assert "runpy.run_module(MODULE, run_name='__main__')" in "".join(ours[2]["source"])


@pytest.mark.parametrize("name", sorted(NOTEBOOKS))
def test_args_ask_for_the_card(name):
    ns = {}
    exec("".join(_cells(HERE / name)[1]["source"]), ns)
    assert "--device" not in ns["ARGS"] and "cpu" not in ns["ARGS"]
    assert ns["MODULE"] == f"dpm_solver_tpu_torch.examples.{make_notebooks.NOTEBOOKS[name]['demo']}"


@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
@pytest.mark.parametrize("name", sorted(NOTEBOOKS))
def test_cells_run_on_the_cpu_and_write_the_demo_files(name, tmp_path, capsys,
                                                       _shallow_score_sde):
    from PIL import Image

    steps, files = NOTEBOOKS[name]
    ns = make_notebooks.run_notebook(HERE / name, ["--device", "cpu"] + steps, outdir=tmp_path)
    assert "no --ckpt" in capsys.readouterr().out
    for f in files:
        assert (tmp_path / f).exists(), sorted(p.name for p in tmp_path.iterdir())
        assert Image.open(tmp_path / f).size[0] > 0
    try:
        import IPython  # noqa: F401
        displays = True
    except ImportError:
        displays = False
    assert ns["DISPLAYED"] == displays and ns["OUTDIR"] == str(tmp_path)


@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
@pytest.mark.parametrize("name", sorted(NOTEBOOKS))
def test_by_default_the_cells_ask_for_the_card(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_notebooks.run_notebook(HERE / name, outdir=tmp_path)
