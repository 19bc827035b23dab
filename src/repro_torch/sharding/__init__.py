"""Sharding of the LM framework over a device mesh: the resolved
partition specs per architecture (``rules``) and the ambient rules the
layers constrain their activations by (``context``)."""
