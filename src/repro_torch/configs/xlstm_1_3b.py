"""xLSTM 1.3B [arXiv:2405.04517; unverified].

48 blocks, d_model 2048, 4 heads, d_ff 0 (blocks are self-contained),
mLSTM:sLSTM at the paper's 7:1 ratio -> segments of (7 mLSTM, 1 sLSTM) x 6.
Recurrent state decode -> long_500k runs with O(1) state.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    segments=(("mlstm", 7), ("slstm", 1)) * 6,
)
