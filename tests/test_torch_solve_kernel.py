"""The contact solve's route and the checks of its CUDA kernel's wrapper,
on the CPU: CPU tensors take the plain version
(``contact_t.solve_contacts_t_reference``) and equal it bit for bit, and
``solve_kernel.check_inputs`` refuses what the kernel does not take.  The
kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``).
"""

import pytest
import torch

from banggameengine_tpu_torch import kernel_cases
from banggameengine_tpu_torch.physics import contact_t
from banggameengine_tpu_torch.physics import solve_kernel as sk


def _case(n=9, c=12, seed=2, ground_only=False):
    case = [torch.as_tensor(a) for a in
            kernel_cases.solve_contact_case(n, c, seed, ground_only)]
    return case[:18], tuple(case[18:])


def _cache(n=9, c=12, seed=4, unique=True):
    """(c_feat [C, N], cache_feat [CB, N], cache_imp [CB, 3, N]) as
    ``step._solve`` hands them over, and the cache as the state keeps it."""
    c_feat, feat, imp = (torch.as_tensor(a) for a in
                         kernel_cases.solve_cache_case(n, c, 12, seed,
                                                       unique))
    return (c_feat, feat.T, imp.permute(1, 2, 0)), (feat, imp)


@pytest.mark.parametrize("ground_only", [False, True])
def test_cpu_tensors_take_the_plain_version(ground_only):
    """No launch, and every output bit-equal to the plain version's, over
    the options the routes pass."""
    args, warm = _case(ground_only=ground_only)
    cache, _ = _cache()
    before = sk.KERNEL.launches
    for kw in (dict(iterations=0), dict(iterations=10, momentum=0.5),
               dict(iterations=3, warm=warm, return_lambdas=True),
               dict(iterations=10, warm=warm, return_lambdas=True,
                    momentum=0.5),
               dict(iterations=10, momentum=0.5, cache=cache)):
        got = contact_t.solve_contacts_t(*args, **kw)
        want = sk.solve_contacts_reference(*args, **kw)
        if "cache" not in kw:
            assert len(want) == len(contact_t.solve_contacts_t_reference(
                *args, **kw))
        assert len(got) == len(want)
        for g, w in zip((*got[:2], *(got[2] if len(got) == 3 else ())),
                        (*want[:2], *(want[2] if len(want) == 3 else ()))):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert sk.KERNEL.launches == before


def test_plain_cache_match_and_refresh():
    """The plain warm start moves each cached impulse whose feature id
    matches exactly, and leaves 0 where none does; the refreshed cache
    keeps the valid slots' ids and impulses, -1 and 0 elsewhere."""
    args, _ = _case()
    (c_feat, *cache), (feat, imp) = _cache()
    warm = sk.cached_warm_start(c_feat, *cache)              # [C, 3, N]
    want = torch.zeros_like(warm)
    for c, n in zip(*torch.nonzero(c_feat >= 0, as_tuple=True)):
        hit = torch.nonzero(feat[n] == c_feat[c, n])
        if len(hit):
            want[c, :, n] = imp[n, int(hit[0, 0])]
    assert torch.equal(warm, want) and bool((want != 0).any())
    valid = args[14]
    ids, imps = sk.refreshed_cache(valid, c_feat, warm.unbind(1))
    assert torch.equal(ids, torch.where(valid, c_feat, -1).T)
    assert torch.equal(imps, torch.where(valid.T[..., None],
                                         warm.permute(2, 0, 1), 0.0))


def _bad(kind):
    """Arguments the kernel does not take, and what the error names."""
    args, warm = _case()
    args = list(args)
    if kind == "dtype":
        args[0] = args[0].double()
        return args, None, "vel must be"
    if kind == "shape":
        args[10] = args[10][:, :-1]
        return args, None, "c_nx must be"
    if kind == "index_dtype":
        args[6] = args[6].long()
        return args, None, "c_prt must be"
    if kind == "device":
        args[15] = args[15].to("meta")
        return args, None, "friction must be"
    if kind == "warm":
        return args, warm[:2], "warm must be 3 planes"
    if kind == "budget":
        return _case(c=sk.MAX_C + 1)[0], None, "past MAX_C"
    if kind == "cache":
        c_feat, feat, imp = (torch.as_tensor(a) for a in
                             kernel_cases.solve_cache_case(9, 12, 12))
        return args, None, "cache_feat must be", (c_feat, feat.T.long(),
                                                  imp.permute(1, 2, 0))
    return args, warm, "runs on CUDA tensors"


@pytest.mark.parametrize("kind", ["dtype", "shape", "index_dtype", "device",
                                  "warm", "cache", "budget", "cpu",
                                  "batched"])
def test_check_inputs_refuses(kind):
    if kind == "batched":
        # a functorch-batched tensor has no pointer of its own to hand over
        args, _ = _case()
        with pytest.raises(ValueError, match="functorch-batched"):
            torch.func.vmap(lambda v: sk.check_inputs(v, *args[1:], None)
                            or v)(torch.stack([args[0], args[0]]))
        return
    args, warm, match, *cache = _bad(kind)
    with pytest.raises(ValueError, match=match):
        sk.check_inputs(*args, warm, *cache)
