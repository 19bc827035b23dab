"""LM serving: prefill and decode steps, greedy generation (``step``) and
the int8 KV cache (``kv_quant``)."""
