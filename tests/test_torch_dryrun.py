"""The port's multi-rank dry run (``tgq_torch.parallel.dryrun``, the
counterpart of ``__graft_entry__.dryrun_multichip``) on 4 gloo CPU ranks:
a TP+DP forward with NLL (within 2e-2 of the single-rank forward), a DP
Hessian (1e-5 of the whole batch's Gram), one quantization pass under the
mesh (``num_layers·7`` packed modules, the same weights on every rank),
and the TP engine against the single-rank engine with int8 and int4 KV by
the two-part rule (teacher-forced logits within 0.02, greedy tokens equal
up to the first top-2 margin below 0.05)."""
import numpy as np

from tgq_torch.parallel.dryrun import dryrun_multichip


def test_dryrun_multichip_four_ranks():
    out = dryrun_multichip(4, device="cpu", timeout_s=300)
    assert out["mesh"] == {"data": 2, "model": 2} and out["backend"] == "gloo"
    assert out["packed"] == 2 * 7 and np.isfinite(out["nll"])
    assert out["forward_max_abs"] < 2e-2 and out["hessian_rel"] < 1e-5
    assert out["tp_logit_max_abs"] < 0.02 and out["tokens"] == 2 * 2 * 4
