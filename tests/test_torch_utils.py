"""The port's checkpoints (``utils/checkpoint.py``) and checked step
(``utils/debug.py``) against the JAX package's on the CPU.

Bars: a file written by either package loads in the other with every
field equal (``comp_mask`` as the same bits), and the next step from the
two loaded states is equal on both (the demo world: the dense route
agrees exactly on the CPU); a port round trip keeps every field, dtype
and the metadata, batched states too; a resumed run is bit-identical to
the uninterrupted one; another format version raises.  The checked step
gives JAX's three messages (and none on a healthy state) and syncs with
the host only in ``throw``; the host spot check raises as JAX's does.
"""

import dataclasses
import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from banggameengine_tpu.engine import make_step_fn as jax_step_fn
from banggameengine_tpu.scene.synthetic import build_demo_like as jax_demo
from banggameengine_tpu.state import InputFrame as JaxInput
from banggameengine_tpu.utils import load_checkpoint as jax_load
from banggameengine_tpu.utils import save_checkpoint as jax_save
from banggameengine_tpu.utils.debug import (
    assert_state_healthy as jax_assert_healthy,
)
from banggameengine_tpu.utils.debug import (
    make_checked_step_fn as jax_checked_step_fn,
)
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.engine import make_step_fn
from banggameengine_tpu_torch.parallel.manyworld import replicate_state
from banggameengine_tpu_torch.scene.synthetic import build_demo_like
from banggameengine_tpu_torch.state import InputFrame
from banggameengine_tpu_torch.utils import load_checkpoint, save_checkpoint
from banggameengine_tpu_torch.utils.checkpoint import FORMAT_VERSION
from banggameengine_tpu_torch.utils.debug import (
    VELOCITY_LIMIT,
    CheckError,
    assert_state_healthy,
    make_checked_step_fn,
)


def _equal(port_state, jax_state) -> None:
    got = convert.world_state_to_numpy(port_state)
    for f in dataclasses.fields(jax_state):
        ref = np.asarray(getattr(jax_state, f.name))
        assert got[f.name].dtype == ref.dtype, f.name
        assert np.array_equal(got[f.name], ref), f.name


@pytest.fixture(scope="module")
def demo():
    """The demo world 60 steps in (the character falling), on both."""
    js, jst = jax_demo()
    ts, tst = build_demo_like(device="cpu")
    jf, tf = jax_step_fn(jst, donate=False), make_step_fn(tst)
    for _ in range(60):
        js, _ = jf(js, JaxInput.zero())
        ts, _ = tf(ts, InputFrame.zero("cpu"))
    _equal(ts, js)
    return js, jf, ts, tf


def test_files_load_in_either_package(demo, tmp_path):
    js, jf, ts, tf = demo
    jax_save(str(tmp_path / "jax"), js, metadata={"by": "jax"})
    save_checkpoint(str(tmp_path / "port"), ts, metadata={"by": "port"})
    from_jax, meta_j = load_checkpoint(str(tmp_path / "jax.npz"),
                                       device="cpu")
    from_port, meta_p = jax_load(str(tmp_path / "port"))
    assert meta_j == {"by": "jax"} and meta_p == {"by": "port"}
    _equal(from_jax, js)
    _equal(ts, from_port)
    assert from_port.comp_mask.dtype == jnp.uint32
    # the next step, from each package's loaded state, equal on both
    s_port, _ = tf(from_jax, InputFrame.zero("cpu"))
    s_jax, _ = jf(from_port, JaxInput.zero())
    _equal(s_port, s_jax)


def test_round_trip_keeps_every_field(demo, tmp_path):
    _, _, ts, _ = demo
    save_checkpoint(str(tmp_path / "a"), ts, metadata={"tag": "t"})
    loaded, meta = load_checkpoint(str(tmp_path / "a"), device="cpu")
    assert meta == {"tag": "t"}
    for f in dataclasses.fields(ts):
        a, b = getattr(ts, f.name), getattr(loaded, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
        assert b.device == torch.device("cpu")
    batched = replicate_state(ts, 3)
    save_checkpoint(str(tmp_path / "b"), batched)
    loaded, _ = load_checkpoint(str(tmp_path / "b"), device="cpu")
    assert loaded.pos.shape == (3,) + ts.pos.shape
    with np.load(tmp_path / "b.npz") as d:
        header = json.loads(bytes(d["__header__"]).decode())
    assert header == {"format_version": FORMAT_VERSION,
                      "capacity": ts.capacity, "batched": True,
                      "metadata": {}}
    assert inspect.signature(load_checkpoint).parameters[
        "device"].default == "cuda"


def test_resume_is_bit_identical(demo, tmp_path):
    _, _, ts, tf = demo
    inp = InputFrame.zero("cpu")
    save_checkpoint(str(tmp_path / "mid"), ts)
    cont = ts
    for _ in range(20):
        cont, _ = tf(cont, inp)
    resumed, _ = load_checkpoint(str(tmp_path / "mid"), device="cpu")
    for _ in range(20):
        resumed, _ = tf(resumed, inp)
    for f in dataclasses.fields(cont):
        assert torch.equal(getattr(cont, f.name), getattr(resumed, f.name))


def test_other_format_version_raises(demo, tmp_path):
    _, _, ts, _ = demo
    p = str(tmp_path / "v")
    save_checkpoint(p, ts)
    with np.load(p + ".npz") as d:
        fields = {k: d[k] for k in d.files}
    hdr = json.loads(bytes(fields["__header__"]).decode())
    hdr["format_version"] = 999
    fields["__header__"] = np.frombuffer(json.dumps(hdr).encode(), np.uint8)
    np.savez(p + ".npz", **fields)
    with pytest.raises(ValueError, match="999"):
        load_checkpoint(p, device="cpu")


def _spoil(state, field, value, row=0):
    t = getattr(state, field).clone()
    t[row, 0] = value
    return dataclasses.replace(state, **{field: t})


@pytest.fixture(scope="module")
def checked_steps():
    js, jst = jax_demo()
    ts, tst = build_demo_like(device="cpu")
    return js, jax_checked_step_fn(jst), ts, make_checked_step_fn(tst)


# (field, value, entity): the quaternion's NaN on the trigger (entity 1),
# which touches no body.  On the character, the JAX package's per-slot
# character step (whose place the port's planar step takes) turns it into
# a NaN position within the step, so JAX reports the position; the port's
# step keeps that position finite
@pytest.mark.parametrize("case", [None, ("pos", np.nan, 0),
                                  ("quat", np.nan, 1), ("lin_vel", 1e6, 0),
                                  ("lin_vel", np.inf, 0)],
                         ids=["healthy", "nan_pos", "nan_quat", "runaway",
                              "inf_vel"])
def test_checked_step_gives_jax_messages(checked_steps, case):
    js, jstep, ts, tstep = checked_steps
    if case is not None:
        field, value, row = case
        js = dataclasses.replace(
            js, **{field: getattr(js, field).at[row, 0].set(value)})
        ts = _spoil(ts, field, value, row)
    j_err, _ = jstep(js, JaxInput.zero())
    t_err, (t_state, _) = tstep(ts, InputFrame.zero("cpu"))
    assert int(t_state.step_idx) == 1
    assert t_err.get() == j_err.get()
    if case is None:
        assert t_err.get() is None
        t_err.throw()
    else:
        with pytest.raises(CheckError, match="at step 1") as info:
            t_err.throw()
        assert isinstance(info.value, ValueError)
        with pytest.raises(checkify.JaxRuntimeError) as jinfo:
            j_err.throw()
        assert str(info.value) == str(jinfo.value)


def test_checked_flags_stay_on_the_device(checked_steps):
    """The step returns tensors, not host values: the flags and the index
    are read only by ``get``/``throw``."""
    _, _, ts, tstep = checked_steps
    err, _ = tstep(_spoil(ts, "lin_vel", 2 * VELOCITY_LIMIT),
                   InputFrame.zero("cpu"))
    assert isinstance(err.failed, torch.Tensor) and err.failed.shape == (3,)
    assert err.failed.tolist() == [False, False, True]
    assert isinstance(err.step, torch.Tensor)


@pytest.mark.parametrize("field", [None, "pos", "lin_vel"])
def test_assert_state_healthy_matches_jax(field):
    js, _ = jax_demo()
    ts, _ = build_demo_like(device="cpu")
    if field is not None:
        js = dataclasses.replace(
            js, **{field: getattr(js, field).at[1, 2].set(jnp.inf)})
        t = getattr(ts, field).clone()
        t[1, 2] = float("inf")
        ts = dataclasses.replace(ts, **{field: t})
    msgs = []
    for check, s in ((jax_assert_healthy, js), (assert_state_healthy, ts)):
        try:
            check(s)
            msgs.append(None)
        except FloatingPointError as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]
    assert (msgs[0] is None) == (field is None)
