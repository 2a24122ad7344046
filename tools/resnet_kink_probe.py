#!/usr/bin/env python3
"""Where whole-model fp32 ResNet gradients part, on the CPU.

    python3 tools/resnet_kink_probe.py

The configuration of ``tests/test_torch_resnet_dp.py``: ``Classifier(
ResNet([1, 1, 1, 1]))``, NHWC, 16 x 16, 16 images of numpy seed 4, from
the JAX model's seed-0 weights.  One JSON line per comparison of the
gradient of one step (for each parameter: the largest difference over
the largest |reference|, and the share of its elements off by more than
1e-4 of that; the five worst parameters):

1. ``jax_sync_bn_dp_vs_merged``: the JAX package's sync-BN data-parallel
   step over 2 CPU devices against its own single-process step on the
   merged batch (each read off a ``MomentumSGD(lr=1)`` update);
2. ``port_vs_jax``: the port's single-process gradient against
   ``jax.grad`` of the JAX model, on the merged batch.

A share near one channel's worth of a parameter (1 / its channel count)
with a large difference is a ReLU or max-pool kink crossed on one side
only; float noise shows as small differences spread over every element.
"""

import json
import os
import sys

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8 "
                      "--xla_backend_optimization_level=0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chainermn_tpu as ct  # noqa: E402
from chainermn_tpu.core import optimizer as JO  # noqa: E402
from chainermn_tpu.core.link import apply_state, extract_state  # noqa: E402
from chainermn_tpu.links import create_mnbn_model  # noqa: E402
from chainermn_tpu.models import Classifier as JClassifier  # noqa: E402
from chainermn_tpu.models.resnet import ResNet as JResNet  # noqa: E402
from chainermn_tpu.serializers.npz import save_npz  # noqa: E402
from chainermn_tpu_torch.models import Classifier, ResNet  # noqa: E402
from chainermn_tpu_torch.serializers import load_npz  # noqa: E402

BLOCKS, N_CLASSES, BATCH, SIZE = [1, 1, 1, 1], 10, 16, 16


def jax_model():
    return JClassifier(JResNet(BLOCKS, n_classes=N_CLASSES, seed=0,
                               layout="NHWC"))


def step_update(model, opt, x, t):
    """The parameters' change of one lr-1 MomentumSGD step: the gradient
    the step applied."""
    before = {p: np.asarray(v.array) for p, v in model.namedparams()}
    opt.update(model, jnp.asarray(x), jnp.asarray(t))
    return {p: before[p] - np.asarray(v.array)
            for p, v in model.namedparams()}


def compare(name, got, want):
    rows = []
    for p, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        d = np.abs(np.asarray(got[p]) - w)
        rows.append([p, float(d.max()) / scale,
                     float((d > 1e-4 * scale).mean())])
    rows.sort(key=lambda r: -r[1])
    print(json.dumps({"comparison": name, "worst": rows[:5]}), flush=True)


def main():
    rng = np.random.RandomState(4)
    x = rng.normal(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    t = rng.randint(0, N_CLASSES, BATCH).astype(np.int32)
    sgd = dict(lr=1.0, momentum=0.9)

    merged = jax_model()
    want = step_update(merged, JO.MomentumSGD(**sgd).setup(merged), x, t)
    comm = ct.create_communicator("jax_ici", devices=jax.devices()[:2])
    dp = create_mnbn_model(jax_model(), comm)
    opt = ct.create_multi_node_optimizer(JO.MomentumSGD(**sgd), comm)
    compare("jax_sync_bn_dp_vs_merged",
            step_update(dp, opt.setup(dp), x, t), want)

    jmodel = jax_model()
    npz = os.path.join("build", "resnet_kink_probe.npz")
    os.makedirs("build", exist_ok=True)
    save_npz(npz, jmodel)
    state = extract_state(jmodel)
    grads = jax.grad(lambda params: apply_state(
        jmodel, {"params": params, "state": state["state"]},
        jnp.asarray(x), jnp.asarray(t))[0])(state["params"])
    model = load_npz(npz, Classifier(ResNet(
        BLOCKS, n_classes=N_CLASSES, seed=1, layout="NHWC", device="cpu")))
    model(torch.from_numpy(x), torch.from_numpy(t)).backward()
    compare("port_vs_jax", {p: v.grad.numpy() for p, v in
                            model.namedparams()},
            {p: np.asarray(g) for p, g in grads.items()})


if __name__ == "__main__":
    main()
