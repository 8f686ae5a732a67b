"""PyTorch port of the ATP system (``repro``), for NVIDIA Hopper GPUs."""
