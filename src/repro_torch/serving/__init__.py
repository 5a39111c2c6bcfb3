"""Deadline-aware LLM serving on the port's transformer."""
