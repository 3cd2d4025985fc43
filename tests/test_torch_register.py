"""`Scene.register_camera` against the JAX package, on the tiny model
(weights carried across by `io/from_jax.py`) at 64 px with
tests/test_torch_slice.py's images, GA at 15 + 8 iterations: three images
through `add_images`, then a fourth registered.

The frozen cameras' chain parameters stay within 1e-6 of before
(tests/test_integration.py's bound); every pose is within 1e-3 of JAX's in
camera 0's frame and the intrinsics within 1e-3 relative
(tests/test_torch_slice.py's tolerances). As in tests/test_torch_slice.py,
the port's scene takes the JAX scene's GA parameters before the call, so
both warm starts agree. (On some random-network scenes the new camera's
pose has a direction the loss does not determine, where Adam turns float
rounding into moves of +-lr, as it does the root camera's gauge; these
images are not such a scene.)
"""

import numpy as np
import torch
from torch_threads import one_torch_thread  # noqa: F401

import starst3r_tpu as st

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.io.from_jax import ga_params_from_jax

from test_torch_polish import _cfg, caches, models  # noqa: F401 (fixtures)
from test_torch_slice import _images, _in_cam0

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def test_register_camera_matches_jax(models, caches):  # noqa: F811
    jmodel, tmodel = models
    imgs = _images(4)
    js = st.Scene(cache_dir=caches[0], config=_cfg(st))
    ts = stt.Scene(cache_dir=caches[1], config=_cfg(stt), device="cpu")
    js.add_images(jmodel, imgs[:3])
    ts.add_images(tmodel, imgs[:3])
    ts.optim_params = ga_params_from_jax(
        [np.array(x) for x in js.optim_params], device="cpu")
    before = [x.clone() for x in ts.optim_params]
    j_new = js.register_camera(jmodel, imgs[3])
    t_new = ts.register_camera(tmodel, imgs[3])
    assert t_new.shape == (4, 4) and np.all(np.isfinite(t_new))
    np.testing.assert_array_equal(t_new, ts.c2w[-1])
    assert ts.c2w.shape == (4, 4, 4)
    assert len(ts.dense_pts) == len(ts.imgs) == len(ts.raw_imgs) == 4
    after = ts.optim_params
    for name in ("quats", "trans", "core_depth"):
        i = after._fields.index(name)
        np.testing.assert_allclose(after[i][:3].numpy(), before[i].numpy(),
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(_in_cam0(ts.c2w), _in_cam0(js.c2w),
                               atol=1e-3)
    np.testing.assert_allclose(_in_cam0(np.stack([ts.c2w[0], t_new])),
                               _in_cam0(np.stack([js.c2w[0], j_new])),
                               atol=1e-3)
    np.testing.assert_allclose(ts.intrinsics, js.intrinsics, rtol=1e-3)
