"""Train ContSep: separation plus a context-driven stream selector.

    python -m cse_tpu_torch.train_ContSep --synthetic_smoke --tot_iters 3 --batch_size 2

The port's counterpart of the root ``train_ContSep.py`` (same flags): PIT
SI-SNR on the separated streams plus the selector loss against the stream
with the highest SI-SNR. Runs on the card unless ``--platform cpu`` is given.
"""

from cse_tpu_torch.core.flags import parse_train_args
from cse_tpu_torch.train.loop import train_net

if __name__ == "__main__":
    train_net(parse_train_args(), variant="contsep")
