"""The demos of `examples/`, ported (dpm_solver_tpu_torch/examples/): each
`main` completes on the CPU at its tiny random-weight default and writes the
files the JAX demo writes; with no card, the default device raises."""

import os

import pytest
import torch

from dpm_solver_tpu_torch.examples import diffedit_demo, latent_imagenet_demo, score_sde_demo

DEMOS = {
    "score_sde": (score_sde_demo, ["--batch", "2", "--steps", "4"],
                  ["demo_pc.png", "demo_dpm.png"]),
    "latent_imagenet": (latent_imagenet_demo, ["--steps", "4"], ["demo_clscond.png"]),
    "diffedit": (diffedit_demo, ["--steps", "4"],
                 ["diffedit_original.png", "diffedit_edited.png", "diffedit_mask.png"]),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_writes_its_files(name, tmp_path, capsys):
    from PIL import Image

    module, argv, files = DEMOS[name]
    module.main(["--device", "cpu", "--outdir", str(tmp_path)] + argv)
    assert "no --ckpt" in capsys.readouterr().out
    for f in files:
        path = tmp_path / f
        assert path.exists(), sorted(os.listdir(tmp_path))
        assert Image.open(path).size[0] > 0


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_asks_for_the_card_by_default(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEMOS[name][0].main(["--outdir", str(tmp_path)])
