"""Data parallelism of the port's ``Trainer`` over two gloo ranks on the
CPU (``parallel.mesh``, ``parallel.launch``), one optimizer step on a
global batch of 4 whose two halves have unequal text and mel lengths (so
the ranks' mask sums, which divide l_length and the KL terms, differ):

* the ranks' step equals one process's step on the whole batch, with
  dropout, posterior, MAS and diffusion noise drawn as that process draws
  them (each rank draws the global batch's tensors and keeps its rows);
* in the deterministic mode (no dropout, no posterior or MAS noise,
  injected t and noise) it equals JAX's ``make_train_step`` on the whole
  batch from the same parameters;
* both ranks end with the same parameters.

Parameters within rtol 1e-5 / atol 1e-6, on the tiny configuration of
``test_torch_remat.py`` (lr 1e-3, eps 1e-2). ``test_torch_dp_accum.py``
does the same with gradient accumulation over 2 micro-batches.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu_torch.parallel import launch
from diff_vits_tpu_torch.train.trainer import Trainer
from diff_vits_tpu_torch.utils.convert import convert_tree, to_flax_params
from test_torch_remat import jax_step, tiny, tiny_batch

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
# rank 0 takes the long items, rank 1 the short ones
TEXT_LENGTHS, SPEC_LENGTHS = (6, 5, 3, 2), (16, 14, 8, 5)


def configs(accum):
    jcfg, pcfg = tiny("none")
    train = dict(train_batch_size=4, gradient_accumulate_every=accum)
    return (dataclasses.replace(jcfg, train=dataclasses.replace(
                jcfg.train, **train)),
            dataclasses.replace(pcfg, train=dataclasses.replace(
                pcfg.train, **train)))


def run(accum):
    """Every number the checks compare, for ``accum`` micro-batches."""
    jcfg, pcfg = configs(accum)
    micro = [tiny_batch(seed=i, text_lengths=TEXT_LENGTHS,
                        spec_lengths=SPEC_LENGTHS) for i in range(accum)]
    port_micro = [m[0] for m in micro]
    rng = np.random.default_rng(9)
    t = np.array([3, 17, 9, 12])
    noise = rng.normal(size=(4, 16, 8)).astype(np.float32)
    inject = [(t, noise)] * accum
    ranks = launch.run_ranks(launch.calls, 2, [
        (launch.train_step, (pcfg, port_micro)),
        (launch.train_step, (pcfg, port_micro, "cpu", inject))])
    single = launch.train_step(pcfg, port_micro)
    start = to_flax_params(Trainer(pcfg, [], device="cpu").model)
    jbatch = {k: jnp.stack([m[1][k] for m in micro]) if accum > 1
              else micro[0][1][k] for k in micro[0][1]}
    ref, ref_metrics = jax_step(jcfg, start, jbatch, t, noise)
    return dict(ranks=ranks, single=single, start=convert_tree(start),
                jax=(convert_tree(ref), ref_metrics))


def assert_params_equal(got, want, start):
    assert set(got) == set(want)
    moved = 0
    for name, a in got.items():
        b = want[name].numpy() if torch.is_tensor(want[name]) else want[name]
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
        moved += not np.array_equal(a, start[name].numpy())
    assert moved > len(got) // 2


def assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def numbers():
    return run(accum=1)


def check_ranks_equal_one_process(numbers):
    (r0_draws, _), (r1_draws, _) = numbers["ranks"]
    params, metrics = numbers["single"]
    assert_params_equal(r0_draws[0], params, numbers["start"])
    assert_metrics_equal(r0_draws[1], metrics)
    for name, a in r0_draws[0].items():
        np.testing.assert_array_equal(a, r1_draws[0][name], err_msg=name)


def check_parity_ranks_equal_jax(numbers):
    (_, r0_parity), (_, r1_parity) = numbers["ranks"]
    ref, ref_metrics = numbers["jax"]
    assert_params_equal(r0_parity[0], ref, numbers["start"])
    assert_metrics_equal(r0_parity[1], ref_metrics)
    for name, a in r0_parity[0].items():
        np.testing.assert_array_equal(a, r1_parity[0][name], err_msg=name)


def test_the_two_halves_have_unequal_mask_sums():
    b, _ = tiny_batch(text_lengths=TEXT_LENGTHS, spec_lengths=SPEC_LENGTHS)
    assert sum(b.text_lengths[:2]) != sum(b.text_lengths[2:])
    assert sum(b.spec_lengths[:2]) != sum(b.spec_lengths[2:])


def test_two_ranks_step_equals_one_process(numbers):
    check_ranks_equal_one_process(numbers)


def test_two_ranks_step_equals_jax_global_step(numbers):
    check_parity_ranks_equal_jax(numbers)
