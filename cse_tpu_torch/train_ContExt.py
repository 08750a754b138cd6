"""Train ContExt: direct context-conditioned target-speech extraction.

    python -m cse_tpu_torch.train_ContExt --synthetic_smoke --tot_iters 3 --batch_size 2

The port's counterpart of the root ``train_ContExt.py`` (same flags):
-SI-SNR objective on the single extracted stream, frozen context encoder
conditioning via prompt tokens in every dual-path block. Runs on the card
unless ``--platform cpu`` is given.
"""

from cse_tpu_torch.core.flags import parse_train_args
from cse_tpu_torch.train.loop import train_net

if __name__ == "__main__":
    train_net(parse_train_args(), variant="context")
