"""xLSTM-1.3B [arXiv:2405.04517; unverified]: sLSTM + mLSTM blocks.

48L, d_model 2048, 4 heads, vocab 50304; recurrent (sub-quadratic) so
the long_500k cell runs.  d_ff = 0: the xLSTM block carries its own
up/down projection (proj_factor 2).
"""
from .base import ModelConfig, SSMConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0),
    ssm=SSMConfig(chunk=64),  # chunk size reused by the mLSTM dual form
    remat_policy="full",
    sub_quadratic=True,
)
