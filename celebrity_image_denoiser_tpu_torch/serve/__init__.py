"""HTTP serving: the /enhance contract on the stdlib server."""
