"""Weight surgery of the PyTorch port (train/surgery.py) against the JAX
package's (centerpoly_tpu/train/surgery.py) and optax.

* `transplant_heads` on two DLA-34 weight sets carried across by
  `weights.state_dict_from_jax`, the donor's `hm` head narrower (its last
  conv skipped for its shape): the same tensors copied, the same count;
* the freeze transform, the global-norm clip and Adam for 3 steps with
  the backbone frozen, then 2 with it unfrozen, against
  `optax.chain(freeze_transform(mask), clip_by_global_norm, adam)` with
  one optimizer state throughout: frozen parameters bit-equal to their
  start, and every parameter within rtol 1e-5, atol 1e-7 of optax's
  (test_torch_train's Adam bounds) after the unfreeze, which holds only
  if the unfrozen ones take Adam's bias correction from the shared count.
"""
import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from torch_port_common import HEADS, jax_dla_variables

from centerpoly_tpu.train import surgery as jsurgery
from centerpoly_tpu_torch.train import state as tstate
from centerpoly_tpu_torch.train.surgery import (freeze_mask, freeze_transform,
                                                transplant_heads)
from centerpoly_tpu_torch.weights import state_dict_from_jax


def _count(printed: str) -> int:
    return int(re.search(r"transplanted (\d+) tensors", printed).group(1))


def test_transplant_heads_matches_jax():
    _, a = jax_dla_variables(HEADS, 16, 64, 128, seed=0)
    _, b = jax_dla_variables({**HEADS, "hm": 4}, 16, 64, 128, seed=1)
    subs = ["hm", "pseudo_depth"]
    with redirect_stdout(io.StringIO()) as out:
        jparams = jsurgery.transplant_heads(a["params"], b["params"], subs,
                                            verbose=True)
    ref = state_dict_from_jax({"params": jparams,
                               "batch_stats": a["batch_stats"]})
    sd_a, sd_b = state_dict_from_jax(a), state_dict_from_jax(b)
    with redirect_stdout(io.StringIO()) as got_out:
        got = transplant_heads(sd_a, sd_b, subs, verbose=True)
    assert got.keys() == ref.keys() == sd_a.keys()
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0,
                                   msg=k)
    copied = {k for k in got if not torch.equal(got[k], sd_a[k])}
    printed = set(re.findall(r"transplant: (\S+)", got_out.getvalue()))
    # hm.0 and pseudo_depth.0/.2 (weight, bias); hm.2 is 4 wide in the donor
    assert copied == printed == {f"{h}.{i}.{p}" for h, i in (
        ("hm", 0), ("pseudo_depth", 0), ("pseudo_depth", 2))
        for p in ("weight", "bias")}
    assert _count(got_out.getvalue()) == _count(out.getvalue()) == 6


class _Net(torch.nn.Module):
    def __init__(self, p0):
        super().__init__()
        for name, leaves in p0.items():
            setattr(self, name, torch.nn.ParameterDict(
                {k: torch.nn.Parameter(torch.tensor(v))
                 for k, v in leaves.items()}))


def test_freeze_then_unfreeze_matches_optax_chain():
    rng = np.random.RandomState(0)
    p0 = {"base": {"weight": rng.randn(3, 4).astype(np.float32),
                   "bias": rng.randn(3).astype(np.float32)},
          "hm": {"weight": rng.randn(2, 3).astype(np.float32)},
          "poly": {"bias": rng.randn(5).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                          p0) for _ in range(5)]
    lr, clip = 1e-2, 2.0

    def chain(mask):
        return optax.chain(jsurgery.freeze_transform(mask),
                           optax.clip_by_global_norm(clip), optax.adam(lr))

    jp = jax.tree.map(jnp.asarray, p0)
    frozen = jsurgery.freeze_mask(jp, ["hm", "poly"])
    thawed = jsurgery.freeze_mask(jp, ["base", "hm", "poly"])
    opt = chain(frozen).init(jp)

    net = _Net(p0)
    mask = freeze_mask(net, ["hm", "poly"])
    assert mask == {"base.weight": False, "base.bias": False,
                    "hm.weight": True, "poly.bias": True}
    st = tstate.create_train_state(net, lr, (), 1, grad_clip=clip,
                                   grad_transform=freeze_transform(mask))

    def step(tx, g):
        nonlocal jp, opt
        upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        for name, leaves in g.items():
            for k, v in leaves.items():
                getattr(net, name)[k].grad = torch.tensor(v)
        st.apply_gradients()

    def compare():
        for name, leaves in jp.items():
            for k, v in leaves.items():
                np.testing.assert_allclose(
                    getattr(net, name)[k].detach().numpy(), np.asarray(v),
                    rtol=1e-5, atol=1e-7, err_msg=f"{name}.{k}")

    for g in grads[:3]:
        step(chain(frozen), g)
    compare()
    for k, v in p0["base"].items():
        assert np.array_equal(net.base[k].detach().numpy(), v)
        assert np.array_equal(np.asarray(jp["base"][k]), v)
    st.grad_transform = freeze_transform(freeze_mask(net, ["base", "hm",
                                                           "poly"]))
    for g in grads[3:]:
        step(chain(thawed), g)
    compare()
    assert not np.array_equal(net.base["weight"].detach().numpy(),
                              p0["base"]["weight"])
    assert all(s["step"] == 5 for s in st.optimizer.state.values())
