"""Command lines of the port, each the counterpart of the JAX package's."""

import argparse


class ArgumentParser(argparse.ArgumentParser):
    """An ArgumentParser whose optional positional arguments added by
    `positional_or_flag` may also be given as `--name`; giving both is an
    error."""

    _either = ()  # the names added by positional_or_flag

    def positional_or_flag(self, name, **kw):
        self.add_argument(f"_{name}", nargs="?", metavar=name, **kw)
        self.add_argument(f"--{name}", type=str, default=None,
                          help=f"the same as the positional {name}")
        self._either += (name,)

    def parse_known_args(self, args=None, namespace=None):
        ns, extra = super().parse_known_args(args, namespace)
        for name in self._either:
            pos = vars(ns).pop(f"_{name}", None)
            if pos is None:
                continue
            if getattr(ns, name) is not None:
                self.error(f"{name} given both as an argument and as "
                           f"--{name}")
            setattr(ns, name, pos)
        return ns, extra
