"""Entry points: the serving launcher (serve)."""
