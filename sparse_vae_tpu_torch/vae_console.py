"""An augmented Python console for a trained Transformer-VAE (the port of
the JAX package's vae-console.py; a module name holds no hyphen):

    python -m sparse_vae_tpu_torch.vae_console [<run-name>] [device=cuda]

`load <run-name>` loads a run that this package's trainer saved
(`load_checkpoint_for_name`: the model as `vae`, its parameters as
`params`, its meta as `meta`) and the run's tokenizer (`tokenizer`,
cli.tokenizer_for_run); `encode <text>` puts the text's posterior into
the environment as `posterior` and prints its mean; `help` lists the
commands; q, quit or exit leaves; anything else is evaluated (or, where
it is a statement, executed) as Python against the live environment.
The model runs on the card unless device=cpu is given.
"""
from __future__ import annotations

import sys

import numpy as np  # noqa: F401  (for the console's expressions)
import torch


class VAEConsole:
    """The console's environment and commands; `run(read)` reads each
    line from read(">>> ") (input by default) until EOF or a quit."""

    def __init__(self, device="cuda"):
        self.device = device
        self.env = {}
        self.commands = {"encode": self.encode, "load": self.load,
                         "help": self.print_help}

    def load(self, version_name: str):
        from . import load_checkpoint_for_name
        from .cli import tokenizer_for_run
        model, _, _, state, meta = load_checkpoint_for_name(
            "transformer-vae", version_name, device=self.device)
        self.env.update(vae=model, params=state["params"], meta=meta,
                        tokenizer=tokenizer_for_run("transformer-vae", meta))
        print(f"Loaded transformer VAE run '{version_name}'.")

    def encode(self, user_string: str):
        model = self.env["vae"]
        ids = self.env["tokenizer"].encode(user_string).ids
        tokens = torch.tensor([ids], dtype=torch.int64, device=model.device)
        with torch.no_grad():
            self.env["posterior"] = model.posterior(tokens)
        print("posterior loc:", self.env["posterior"].loc)

    def print_help(self, _=None):
        print(list(self.commands.keys()))

    def run(self, read=input):
        print("This is an augmented Python console. Type 'help' for "
              "commands.")
        while True:
            try:
                command = read(">>> ")
            except (EOFError, StopIteration):
                return
            if command in ("q", "quit", "exit"):
                return
            for name, func in self.commands.items():
                if command == name:
                    func() if name == "help" else func("")
                    break
                if command.startswith(name + " "):
                    func(command[len(name) + 1:])
                    break
            else:
                self.execute(command)

    def execute(self, command: str):
        try:
            result = eval(command, globals(), self.env)  # noqa: S307
            if result is not None:
                print(result)
        except SyntaxError:
            try:
                exec(command, globals(), self.env)  # noqa: S102
            except Exception as e:
                print(repr(e))
        except Exception as e:
            print(repr(e))


def main(args, read=input) -> VAEConsole:
    """args: sys.argv; `read(prompt)` gives each line (input() by
    default). Returns the console, its environment as the session left
    it."""
    names = [a for a in args[1:] if "=" not in a]
    extra = dict(a.split("=", 1) for a in args[1:] if "=" in a)
    device = extra.pop("device", "cuda")
    if extra or len(names) > 1:
        raise SystemExit(__doc__)
    console = VAEConsole(device)
    if names:
        console.load(names[0])
    else:
        print("No run loaded; use `load <run-name>`.")
    console.run(read)
    return console


if __name__ == "__main__":
    main(sys.argv)
