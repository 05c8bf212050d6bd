"""Port vs JAX: train, eval and predict steps and the optimizers.

From the same parameters and batch, two updates of plain SGD, momentum SGD
and Adam (optax's, against torch.optim's with the learning rate set by
hand at each update), on a stage with a bottleneck input and with the
soft F-beta or the cross-entropy loss. The schedule decays after every
update, so an off-by-one in its step count would show in the second
update. Checked: the losses, the first update's gradients and the updated
parameters, rtol 1e-5 (f32 convolutions and products summed in other
orders; after Adam's updates also atol 1e-5, see below); the staircase
schedule at steps 0, 1 and k * decay_steps, rtol 1e-6 (f32 powers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.train import losses as jlosses
from rapidobjectdetectionusingcascadedcnns_tpu.train import optimizer as jopt
from rapidobjectdetectionusingcascadedcnns_tpu.train import train_step as jstep
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cnn as tcnn
from rapidobjectdetectionusingcascadedcnns_torch.train import optimizer as topt
from rapidobjectdetectionusingcascadedcnns_torch.train import train_step as tstep

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)
RTOL = 1e-5
N, SIZE, BNECK = 64, 24, 32
LR, DECAY = 0.05, 0.5


def _schedules():
    # decay_steps 1: the learning rate halves after every update
    return (jopt.exponential_decay_staircase(LR, DECAY, 1.0, 0.001),
            topt.exponential_decay_staircase(LR, DECAY, 1.0, 0.001))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (N, SIZE, SIZE, 3)).astype(np.uint8)
    labels = (rng.rand(N) < 0.4).astype(np.int32)
    bneck = rng.normal(0, 1, (N, BNECK)).astype(np.float32)
    mean = images.astype(np.float32).mean(axis=0)
    std = images.astype(np.float32).std(axis=0) + 1.0
    jcfg = jcnn.StageConfig(input_size=SIZE, conv_filter_sizes=(8,), fc1_size=32,
                            bottleneck_in_size=BNECK, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jcnn.init_stage(jax.random.PRNGKey(4), jcfg))
    tcfg = bridge.stage_config_from_jax(jcfg)
    return images, labels, bneck, mean, std, jcfg, tcfg, params


def _leaves_np(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def _port_leaves(params):
    # the JAX pytree's leaf order: conv (W, b), fc1 (W, b), fc2 (W, b)
    return [t.detach().numpy() for t in tstep.param_leaves(params)]


@pytest.mark.parametrize(
    "opt_id, f_beta",
    [(0, 4.0), (2, None), (1, 4.0)],
    ids=["sgd-fbeta", "momentum-cross-entropy", "adam-fbeta"],
)
def test_two_updates_match_jax(setup, opt_id, f_beta):
    images, labels, bneck, mean, std, jcfg, tcfg, params = setup
    jsched, tsched = _schedules()
    joptim = {0: optax.sgd(jsched), 2: optax.sgd(jsched, momentum=0.9),
              1: optax.adam(jsched)}[opt_id]
    settings = dict(f_beta=f_beta, positive_proportion=0.4, weighted=True, normalize=False,
                    l2_strength=0.001, l1_strength=0.0, dropout_keep=1.0)

    # JAX: the fused jitted step, and the first update's gradients
    jstate = jstep.TrainState(jax.tree_util.tree_map(jnp.asarray, params),
                              joptim.init(params), jnp.zeros((), jnp.int32))
    step = jstep.make_train_step(jcfg, joptim, jstep.LossSettings(**settings))

    def jloss(p):
        x = (jnp.asarray(images, jnp.float32) - mean) / std
        out = jcnn.apply_stage(p, jcfg, x, jnp.asarray(bneck))
        return jlosses.total_loss(out, jnp.asarray(labels), p, f_beta=f_beta,
                                  positive_proportion=0.4, l2_strength=0.001)

    jgrads = _leaves_np(jax.jit(jax.grad(jloss))(jstate.params))
    jlosses_seen = []
    for _ in range(2):
        jstate, loss = step(jstate, jnp.asarray(images), jnp.asarray(labels),
                            jnp.asarray(bneck), jnp.asarray(mean), jnp.asarray(std),
                            jax.random.PRNGKey(0), jnp.ones((N,), bool))
        jlosses_seen.append(float(loss))

    # the port, from the same parameters
    tparams = tstep.trainable(bridge.params_from_numpy(params, "cpu"), torch.device("cpu"))
    tstate = tstep.TrainState(tparams, topt.make_optimizer(
        tstep.param_leaves(tparams), tsched, opt_id, 0.9))
    gen = torch.Generator().manual_seed(0)
    args = (torch.tensor(images), torch.tensor(labels).long(), torch.tensor(bneck),
            torch.tensor(mean), torch.tensor(std), gen, gen)
    tlosses_seen = []
    for i in range(2):
        loss = tstep.train_step(tstate, tcfg, tstep.LossSettings(**settings), None, *args)
        tlosses_seen.append(float(loss))
        if i == 0:
            for g, r in zip([t.grad.numpy() for t in tstep.param_leaves(tparams)], jgrads):
                np.testing.assert_allclose(g, r, rtol=RTOL, atol=1e-7)
    assert tstate.step == 2 and int(jstate.step) == 2
    np.testing.assert_allclose(tlosses_seen, jlosses_seen, rtol=RTOL)
    # Adam moves every parameter by about the learning rate whatever its
    # gradient, g / (|g| + eps): where |g| is near eps (1e-8) the update
    # follows the gradient's last bits, up to lr * 2e-4 absolute here
    atol = 1e-5 if opt_id == 1 else 1e-7
    for g, r in zip(_port_leaves(tstate.params), _leaves_np(jstate.params)):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=atol)


def test_schedule_matches_jax():
    """Staircase decay with its floor, from the config as the trainers
    build it (decay_steps = iterations_total / 20), and by hand."""
    for cf in (jcf, tcf):
        cf.set("learning_rate_init", 0.01)
        cf.set("learning_rate_decay", 0.9)
    jsched = jopt.lr_schedule_from_config(400)
    tsched = topt.lr_schedule_from_config(400)
    decay_steps = 400 / 20.0
    for step in [0, 1, 19, 20, 21] + [int(k * decay_steps) for k in range(2, 40, 3)]:
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6)
    assert tsched(0) == tsched(19) == float(np.float32(0.01))
    assert tsched(10 ** 6) == float(np.float32(0.001))  # floored
    j, t = _schedules()
    for step in (0, 1, 2, 3, 7):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6)


def test_eval_and_predict_steps_match_jax(setup):
    images, labels, bneck, mean, std, jcfg, tcfg, params = setup
    mask = np.arange(N) < N - 5
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jstep.make_eval_step(jcfg, 4.0)(jp, jnp.asarray(images), jnp.asarray(labels),
                                          jnp.asarray(bneck), jnp.asarray(mean),
                                          jnp.asarray(std), jnp.asarray(mask))
    tp = bridge.params_from_numpy(params, "cpu")
    targs = (torch.tensor(images), torch.tensor(labels), torch.tensor(bneck),
             torch.tensor(mean), torch.tensor(std))
    got = tstep.eval_step(tp, tcfg, *targs, torch.tensor(mask), 4.0)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL)
    best, probs, bn = jstep.make_predict_step(jcfg)(
        jp, jnp.asarray(images), None, jnp.asarray(bneck), jnp.asarray(mean), jnp.asarray(std))
    tbest, tprobs, tbn = tstep.predict_step(tp, tcfg, targs[0], targs[2], targs[3], targs[4])
    np.testing.assert_array_equal(tbest.numpy(), np.asarray(best))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), rtol=RTOL, atol=1e-7)
    # fc1 sums 4,608 products: values near 0 carry the sum's absolute rounding
    np.testing.assert_allclose(tbn.numpy(), np.asarray(bn), rtol=RTOL, atol=1e-5)
    # dropout: keep-probability semantics, a mask from the generator
    x = torch.zeros((N, SIZE, SIZE, 3))
    outs = [tcnn.apply_stage(tp, tcfg, x, targs[2], dropout_keep=0.5,
                             generator=torch.Generator().manual_seed(3))["logits"]
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="generator"):
        tcnn.apply_stage(tp, tcfg, x, targs[2], dropout_keep=0.5)
