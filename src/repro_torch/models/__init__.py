"""Parameter schemas and the bridge from the reference's param trees."""
