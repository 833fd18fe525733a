"""The port's multi-device dryrun (ragfin_tpu_torch.parallel.dryrun) on CPU
meshes: stages 2-6 of ``__graft_entry__.dryrun_multichip`` (pp(+dp) and sp
MiniLM against the encoder within 1e-5, sharded top-k and IVF
self-retrieval, sharded graph match equal to the store's, fusion over the
sharded results). Without devices it needs a card."""

import pytest
import torch

from ragfin_tpu_torch.parallel.dryrun import dryrun_multichip


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_on_cpu_devices(n):
    dryrun_multichip(n, devices=["cpu"] * n)


def test_dryrun_needs_devices():
    with pytest.raises(ValueError, match="devices for a 4-device"):
        dryrun_multichip(4, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(2)
