"""Focal-loss backward launches a training step: the program's
``focal.backward`` counter (one a pyramid level a backward, in the autograd
Function of ``kernels/focal.py``) over the pass's steps, on rank 0
(rnbench/spans.py). None where the program has no such counter: a program
whose focal loss runs as an elementwise composition under autograd."""

from rnbench import spans

LAYER = "loss"
UNIT = "count"
MOVES = "train_img_s"
SOURCE = "program_counter"


def read(run):
    result = spans.program_pass(run)
    if not result:
        return None
    n = result["records"]["counters"].get("focal.backward")
    return None if n is None else n / result["steps"]
