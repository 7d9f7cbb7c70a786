"""Training: AdamW with the reference's schedules, and int8 gradient
compression with error feedback (the counterpart of ``repro.train``)."""
