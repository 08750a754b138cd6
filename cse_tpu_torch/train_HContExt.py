"""Train H-ContExt: extraction with joint dialog-history + speaker-voice cues.

    python -m cse_tpu_torch.train_HContExt --ecapa_path embedding_model.ckpt
    python -m cse_tpu_torch.train_HContExt --synthetic_smoke --platform cpu --debug_tiny_model --tot_iters 3

The port's counterpart of the root ``train_HContExt.py`` (same flags):
ContExt plus a frozen speaker embedding of a random 1-5 s enrollment crop
as a second cue, with stochastic cue dropout (joint 0.3 / history 0.35 /
voice 0.35 per step). ``--ecapa_path`` takes the released speechbrain
``embedding_model.ckpt``; without it training refuses the stand-in unless
``--synthetic_smoke`` or ``--allow_stub_nets``. Runs on the card unless
``--platform cpu`` is given.
"""

from cse_tpu_torch.core.flags import parse_train_args
from cse_tpu_torch.train.loop import train_net

if __name__ == "__main__":
    train_net(parse_train_args(), variant="hcontext")
