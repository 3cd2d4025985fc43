"""The port's `convert` subcommand and `io.torch_convert.convert_file` against
the JAX package's `convert_file`, on the CPU: a tiny ``.pth`` in the public
MASt3R layout (the JAX `synthetic_state_dict`, with one leaf of a wrong
shape and one key nothing maps) becomes an ``.npz`` that the JAX
`Mast3rModel.from_pretrained` loads, every mapped leaf bit for bit the JAX
file's, with the same list of mismatches and unmapped keys. Its own file:
the JAX `convert_file` and `from_pretrained` initialise a JAX model each,
which takes most of this file's time.
"""

import numpy as np
import torch
from torch_threads import one_torch_thread  # noqa: F401

import starst3r_tpu as st
from starst3r_tpu.io.torch_convert import convert_file as j_convert_file
from starst3r_tpu.io.torch_convert import convert_state_dict as j_mapping
from starst3r_tpu.io.torch_convert import synthetic_state_dict

from starst3r_tpu_torch import cli
from starst3r_tpu_torch.io.torch_convert import convert_file
from starst3r_tpu_torch.utils.checkpoint import flatten


def test_convert_matches_jax(tmp_path):
    cfg = st.model_preset("tiny")
    sd = synthetic_state_dict(cfg, seed=1)
    sd["enc_norm.bias"] = np.zeros(3, np.float32)    # a wrong shape
    sd["extra.weight"] = np.ones(2, np.float32)      # nothing maps it
    pth = str(tmp_path / "tiny.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               pth)

    j_out = str(tmp_path / "jax.npz")
    want = j_convert_file(pth, j_out, preset="tiny", verbose=False)
    got = convert_file(pth, str(tmp_path / "port.npz"), preset="tiny",
                       verbose=False, device="cpu")
    assert got == want
    assert any("norm/bias" in m for m in got) and "extra.weight" in got

    c_out = str(tmp_path / "cli.npz")
    assert cli.main(["--device", "cpu", "convert", "--pth", pth, "--out",
                     c_out, "--preset", "tiny"]) == 0
    model = st.Mast3rModel.from_pretrained(c_out)
    assert model.cfg == cfg

    mapped, _ = j_mapping(sd, cfg.enc_depth, cfg.dec_depth, cfg.patch_size,
                          cfg.desc_dim)
    mapped = flatten(mapped)
    with np.load(j_out) as jz, np.load(c_out) as pz, \
            np.load(str(tmp_path / "port.npz")) as fz:
        assert sorted(pz.files) == sorted(jz.files) == sorted(fz.files)
        n_mapped = 0
        for key, value in mapped.items():
            if jz[key].shape != value.shape:
                continue                      # a mismatch: left at init
            for z in (pz, fz):
                assert z[key].dtype == jz[key].dtype, key
                np.testing.assert_array_equal(z[key], jz[key], err_msg=key)
            n_mapped += 1
        assert n_mapped == len(mapped) - 1
        np.testing.assert_array_equal(pz["__config__"], jz["__config__"])
