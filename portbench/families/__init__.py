"""How each model family of the program is built, run and watched."""
