"""Pretrain a plain Sepformer (no context): PIT SI-SNR separation.

    python -m cse_tpu_torch.train_Sepformer --synthetic_smoke --tot_iters 3 --batch_size 2

The port's counterpart of the root ``train_Sepformer.py`` (same flags; the
context path is unused). Runs on the card unless ``--platform cpu`` is given.
"""

from cse_tpu_torch.core.flags import parse_train_args
from cse_tpu_torch.train.loop import train_net

if __name__ == "__main__":
    train_net(parse_train_args(), variant="base")
