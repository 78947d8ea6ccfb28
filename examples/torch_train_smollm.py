"""Train a reduced smollm-135m for a few hundred steps with fault tolerance,
on the PyTorch/CUDA port (the card unless ``--device cpu`` is given).

    PYTHONPATH=src python examples/torch_train_smollm.py
    PYTHONPATH=src python examples/torch_train_smollm.py --device cpu

Exercises the training substrate end to end: the train step
(``distribution/steps.py::make_train_step``), AdamW, atomic async
checkpoints, an injected mid-run failure with automatic restore, and
straggler detection. Delete ``experiments/torch_example_ckpt`` to start
fresh.
"""
import sys

from repro_torch.launch import train

train.main([
    "--arch", "smollm_135m",
    "--steps", "300",
    "--batch", "8",
    "--seq", "128",
    "--ckpt-every", "50",
    "--ckpt-dir", "experiments/torch_example_ckpt",
    "--inject-failure", "120",
    "--log-every", "25",
] + sys.argv[1:])
