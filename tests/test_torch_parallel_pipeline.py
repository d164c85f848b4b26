"""The port's GPipe trunk (``parallel/pipeline.py``) on the CPU, against the
serial trunk and the JAX ``resnet_trunk_pipeline``, the cases of
tests/test_pipeline.py: 6 ``ResidualBlock``s of 8 channels, x (8, 12, 12, 8),
(stages, microbatches) in {(2, 4), (3, 2)} on 2 and 3 gloo ranks
(``torch_dist_ranks.spawn``), and one stage in one process.

- Forward: the port's pipelined trunk = the port's serial trunk to 1e-5 and
  = the JAX pipelined trunk on the same weights (flax init, bridged) to
  2e-5, the JAX test's bounds (rtol 1e-5, atol 2e-5).
- Gradients of sum(y²): to x within rtol 1e-4 / atol 5e-5 of the serial
  trunk's, to every conv kernel within rtol 1e-4 / atol 1e-2 (JAX's test:
  kernel gradients of O(1e4)); the conv biases, whose true gradient is 0
  (instance norm removes them), hold only float32 noise on both sides and
  are bounded by 1e-2 in size, as in the JAX test.
- One SGD step of mean((y - 0.5)²) through the pipeline lowers the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from tfcgan_tpu.models.resnet_gen import ResidualBlock as JaxResidualBlock
from tfcgan_tpu.parallel.pipeline import make_pipe_mesh as jax_pipe_mesh
from tfcgan_tpu.parallel.pipeline import resnet_trunk_pipeline as jax_trunk_pipeline
from tfcgan_tpu_torch.bridge import conv_net_from_flax

FEATS, BLOCKS = 8, 6


@pytest.fixture(scope="module")
def trunk():
    block = JaxResidualBlock(FEATS, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(0), (8, 12, 12, FEATS))
    params = [block.init(jax.random.PRNGKey(i), x[:1])["params"] for i in range(BLOCKS)]
    port = [{k: v.numpy() for k, v in conv_net_from_flax(p).items()} for p in params]
    return block, params, np.array(x), port


def _serial(port, x):
    """The port's serial trunk: y, and the gradients of sum(y²)."""
    block = ranks.trunk_block(port)
    ps = [{k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()} for p in port]
    h = xt = torch.from_numpy(x).requires_grad_(True)
    for p in ps:
        h = torch.func.functional_call(block, p, (h,))
    h.square().sum().backward()
    return h.detach().numpy(), xt.grad.numpy(), [{k: v.grad.numpy() for k, v in p.items()}
                                                for p in ps]


@pytest.mark.parametrize("stages,microbatches", [(2, 4), (3, 2), (1, 4)])
def test_pipeline_matches_the_serial_trunk_and_jax(trunk, stages, microbatches, tmp_path):
    block, params, x, port = trunk
    kw = dict(params=port, x=x, microbatches=microbatches, stages=stages)
    if stages > 1:
        outs = ranks.spawn("pipeline_checks", stages, tmp_path, **kw)
    else:
        outs = [ranks.pipeline_checks(0, 1, **kw)]  # no process group: a stage of one
    y_ref, gx_ref, gp_ref = _serial(port, x)
    y_jax = jax_trunk_pipeline(lambda p, h: block.apply({"params": p}, h), params,
                               jnp.asarray(x), mesh=jax_pipe_mesh(stages),
                               microbatches=microbatches)
    for out in outs:  # replicated out: every rank holds the whole output and gradients
        np.testing.assert_allclose(out["y"], y_ref, rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(out["y"], np.asarray(y_jax), rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(out["gx"], gx_ref, rtol=1e-4, atol=5e-5)
        for got, want in zip(out["gp"], gp_ref):
            assert sorted(got) == sorted(want)
            for k in want:
                if k.endswith("bias"):
                    assert np.abs(got[k]).max() < 1e-2 and np.abs(want[k]).max() < 1e-2, k
                else:
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-2, err_msg=k)
        l0, l1 = out["descent"]
        assert np.isfinite(l0) and l1 < l0
