"""The port's glass (shenqi_tpu_torch/genic/glass.py, the damped
reversed-PM steps on the port's pm_forces) against the JAX package's
make_glass on the CPU, from the same seed: positions within 2e-5 of the
box per coordinate (periodic distance; the f32 PM forces differ in their
last bits, and each step truncates the displacement to whole fixed-point
units), and tests/test_thermal_glass.py:49's sub-Poisson check on the
port's own glass: its CIC cell variance under half a random field's."""

import numpy as np
import pytest
import torch

from shenqi_tpu.genic.glass import make_glass as j_glass
from shenqi_tpu_torch.core.particles import float_to_ipos
from shenqi_tpu_torch.genic.glass import make_glass as t_glass
from shenqi_tpu_torch.ops.cic import cic_deposit

torch.set_num_threads(2)


@pytest.mark.parametrize("ng,nsteps", [(8, 10), (12, 25)])
def test_glass_parity(ng, nsteps):
    box = 10000.0
    gj = j_glass(ng, box, seed=2, nsteps=nsteps)
    gt = t_glass(ng, box, seed=2, nsteps=nsteps, device="cpu")
    assert gt.shape == (ng ** 3, 3) and gt.dtype == np.float64
    assert (gt >= 0).all() and (gt < box).all()
    d = gt - gj
    d -= box * np.round(d / box)
    assert np.abs(d).max() < 2e-5 * box


def test_glass_suppresses_shot_noise():
    ng, box = 12, 10000.0
    glass = t_glass(ng, box, seed=2, nsteps=25, device="cpu")

    def cell_var(pos):
        mesh = cic_deposit(float_to_ipos(pos, box, device="cpu"),
                           torch.ones(len(pos)), ng)
        return float(mesh.var(unbiased=False))

    rand = np.random.RandomState(3).uniform(0, box, (ng ** 3, 3))
    assert cell_var(glass) < 0.5 * cell_var(rand)
