"""Frozen-BN backward launches a training step: the program's
``frozen_bn.backward`` counter (one a frozen BN a backward, in the autograd
Function of ``kernels/frozen_bn.py``) over the pass's steps, on rank 0
(rnbench/spans.py). None where the program has no such counter: a program
whose frozen BN runs eval-mode ``F.batch_norm`` under autograd."""

from rnbench import spans

LAYER = "backward"
UNIT = "count"
MOVES = "train_img_s"
SOURCE = "program_counter"


def read(run):
    result = spans.program_pass(run)
    if not result:
        return None
    n = result["records"]["counters"].get("frozen_bn.backward")
    return None if n is None else n / result["steps"]
