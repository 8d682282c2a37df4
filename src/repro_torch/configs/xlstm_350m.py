"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]

d_ff=0: xLSTM blocks carry their own up/down projections (mLSTM
proj-factor 2, sLSTM post-FFN factor 4/3); an sLSTM block every 8th
layer (3 of 24), mLSTM blocks elsewhere.
"""
from repro_torch.models.xlstm import XLSTMConfig

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab=50304,
    activation="geglu",
    norm="rmsnorm",
    xlstm=XLSTMConfig(n_heads=4, conv_kernel=4, chunk=64, slstm_every=8),
    family="ssm",
    long_context_capable=True,
    train_microbatches=2,
)
