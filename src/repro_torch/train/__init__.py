"""LM training: AdamW with clipping and int8 gradient compression
(``optimizer``), the loss and train step (``step``) and atomic,
resumable checkpoints (``checkpoint``)."""
