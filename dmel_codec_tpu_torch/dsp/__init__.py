"""Log-mel front end."""
