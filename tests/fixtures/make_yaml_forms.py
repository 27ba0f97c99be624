"""Regenerate the ``.json`` beside each ``yaml_forms/*.yaml``: what PyYAML's
``yaml.safe_load`` returns for the file (every value JSON can hold). The
port's YAML reader is held to them on the CPU (``tests/test_torch_yaml.py``)
and on the GPU machine, which has no PyYAML (``chip_smoke.py``
``config_phase``).

    python tests/fixtures/make_yaml_forms.py
"""

import glob
import json
import os

import yaml

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "yaml_forms")


def main() -> None:
    for path in sorted(glob.glob(os.path.join(HERE, "*.yaml"))):
        with open(path, encoding="utf-8") as f:
            data = yaml.safe_load(f)
        with open(path[: -len(".yaml")] + ".json", "w", encoding="utf-8") as f:
            json.dump(data, f, indent=1, ensure_ascii=True)
            f.write("\n")
        print("wrote", os.path.basename(path)[: -len(".yaml")] + ".json")


if __name__ == "__main__":
    main()
