from .serve_loop import ServeConfig, Server

__all__ = ["ServeConfig", "Server"]
