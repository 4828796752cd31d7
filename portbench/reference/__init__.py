"""The plain reference and the comparisons that decide ``correct``.
Nothing here imports the program."""
