"""Training substrate, counterpart of ``repro/training``: AdamW (f32 or
int8-blockwise moments) and its schedule, the train step with gradient
accumulation, and int8 gradient compression with error feedback."""
