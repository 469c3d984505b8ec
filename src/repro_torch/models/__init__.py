"""Model zoo of the port: every registered family, served and trained."""
