"""Training (the port's copy of the reference's `train` package): the
hand-rolled AdamW with f32 masters and optional 8-bit state
(`optimizer.py`), int8 error-feedback gradient compression
(`compression.py`) and the train step (`train_step.py`)."""
