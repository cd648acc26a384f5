"""The token pipeline of training (``pipeline.TokenPipeline``), its index
resolved through a Clock2Q+ cache."""
