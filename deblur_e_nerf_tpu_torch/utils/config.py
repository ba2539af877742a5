"""Configuration loading (counterpart of deblur_e_nerf_tpu/utils/config.py).

Same YAML schema and the same attribute-access `ConfigDict`. `yaml` is
imported only inside `load_config`/`save_config`, so the package imports
without PyYAML; `ConfigDict.from_dict` builds a config in code.
"""

import copy


class ConfigDict(dict):
    """A dict with attribute access, recursively applied to nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for key, value in d.items():
            self[key] = value

    @classmethod
    def from_dict(cls, d):
        return cls(copy.deepcopy(dict(d)))

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, ConfigDict._wrap(value))

    def __setattr__(self, name, value):
        self[name] = value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self):
        def unwrap(value):
            if isinstance(value, ConfigDict):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return type(value)(unwrap(v) for v in value)
            return value

        return unwrap(self)


def load_config(path):
    """Load a YAML config file (reference schema) into a ConfigDict."""
    import yaml

    with open(path) as f:
        return ConfigDict(yaml.safe_load(f))


def save_config(config, path):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(
            config.to_dict() if isinstance(config, ConfigDict) else config, f
        )
