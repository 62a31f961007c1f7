"""The port's checkpoint path utility (dpm_solver_tpu_torch/utils/ckpt_util.py)
against the JAX package's: the same tables, the same resolution of names
to the on-disk layout, md5 checking, and the same errors (a missing file
names its source URL; nothing is downloaded)."""

import hashlib
import os

import pytest

from dpm_solver_tpu.utils import ckpt_util as jck
from dpm_solver_tpu_torch.utils import ckpt_util as pck


def test_tables_equal_jax():
    assert pck.URL_MAP == jck.URL_MAP
    assert pck.CKPT_MAP == jck.CKPT_MAP
    assert pck.MD5_MAP == jck.MD5_MAP
    assert set(pck.URL_MAP) == set(pck.CKPT_MAP) == set(pck.MD5_MAP)


@pytest.mark.parametrize("name", sorted(jck.URL_MAP))
def test_resolves_each_name_as_jax_does(tmp_path, name):
    p = tmp_path / pck.CKPT_MAP[name]
    os.makedirs(p.parent, exist_ok=True)
    p.write_bytes(name.encode())
    got = pck.get_ckpt_path(name, root=str(tmp_path))
    assert got == jck.get_ckpt_path(name, root=str(tmp_path)) == str(p)


def test_md5_checking(tmp_path):
    payload = os.urandom(3 << 20)   # past one streaming chunk
    p = tmp_path / pck.CKPT_MAP["cifar10"]
    os.makedirs(p.parent, exist_ok=True)
    p.write_bytes(payload)
    assert pck.md5_hash(str(p)) == jck.md5_hash(str(p)) == hashlib.md5(payload).hexdigest()
    messages = []
    for mod in (pck, jck):
        with pytest.raises(ValueError, match="md5") as err:
            mod.get_ckpt_path("cifar10", root=str(tmp_path), check=True)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_errors_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    for name in ("lsun_bedroom", "ema_lsun_church_outdoor"):
        errs = []
        for mod in (pck, jck):
            with pytest.raises(FileNotFoundError, match="heibox") as err:
                mod.get_ckpt_path(name)
            errs.append(str(err.value))
        assert errs[0] == errs[1]
        assert str(tmp_path / "cache" / "diffusion_models_converted") in errs[0]
    for mod in (pck, jck):
        with pytest.raises(KeyError, match="nope"):
            mod.get_ckpt_path("nope")


def test_church_outdoor_aliases_to_church(tmp_path):
    p = tmp_path / pck.CKPT_MAP["lsun_church"]
    os.makedirs(p.parent, exist_ok=True)
    p.write_bytes(b"x")
    assert pck.get_ckpt_path("lsun_church_outdoor", root=str(tmp_path)) == str(p)
