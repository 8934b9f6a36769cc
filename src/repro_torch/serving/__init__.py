"""The serving front-end."""
