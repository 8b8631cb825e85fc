from dpot_tpu_torch.serve.server import ModelRouter, RolloutServer, serve, serve_multi

__all__ = ["ModelRouter", "RolloutServer", "serve", "serve_multi"]
