"""Eigensolvers: the production soft-locking LOBPCG and its dense algebra."""
