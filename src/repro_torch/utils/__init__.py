"""Small shared tensor helpers."""
