"""Checks shared by the port's whole-step parity tests (ROADMAP C6):
parameters after one Adam step and Adam's first moment, as flax trees of
numpy arrays, the port's against the JAX package's."""

import jax
import numpy as np


def assert_adam_step_close(got, want, lr):
    """Adam's first update is lr*g/(|g|+eps): where the two frameworks'
    gradients differ in sign, the parameters differ by up to 2*lr. Such
    flips come from near-zero gradients and from near-ties of the ReLUs:
    on test_torch_steps.py's batch 2 of the 131,072 outputs of the last
    decoder BatchNorm sit on opposite sides of zero in the two frameworks
    (values within 1e-5 of each other), and those two pixels' gradients
    reach every earlier layer. So: every element within the 2*lr bound of
    one flip, and at least 99% of all parameter elements within atol 3e-4."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    d = np.concatenate([np.abs(g - w).ravel()
                        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want))])
    assert d.max() <= 2 * lr + 1e-6
    assert np.mean(d <= 3e-4) >= 0.99


def assert_first_moment_close(got, want):
    """Adam's first moment after one step is (1 - b1) * g: the gradients
    themselves, whose scale the sign-like parameter update cannot check.
    The same ReLU near-ties move them too (at most 2.5% of a tensor's
    largest gradient, 0.7% in relative L2 norm on this batch), so: each
    tensor within 5% of its largest value, and all within 2% in L2 norm."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    num = den = 0.0
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max()
        num += float(np.square(g - w).sum())
        den += float(np.square(w).sum())
    assert np.sqrt(num / den) <= 2e-2
