"""The paper's technique as an LM feature: the CPD-factorized embedding."""
from .cpd_embedding import (CPDEmbed, cpd_embed, cpd_logits, dense_table,
                            init_cpd_embedding, split_dims)

__all__ = ["CPDEmbed", "cpd_embed", "cpd_logits", "dense_table",
           "init_cpd_embedding", "split_dims"]
