"""Training (mirrors ``src/repro/train/``): AdamW with f32 or int8 moments,
the synthetic token pipeline, atomic checkpoints and the trainer loop."""
