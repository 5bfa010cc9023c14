from setuptools import find_packages, setup

setup(name='dgsqp_tpu',
      version='0.1.0',
      description='TPU-native dynamic-game SQP framework (DGSQP capabilities on jax/XLA)',
      packages=find_packages(include=['dgsqp_tpu', 'dgsqp_tpu.*',
                                      'dgsqp_torch', 'dgsqp_torch.*']),
      package_data={'dgsqp_torch.ops': ['csrc/*.cu'],
                    'dgsqp_torch.tracks': ['track_data/*.npz'],
                    'dgsqp_torch.harness': ['data/*.npz', 'data/*.csv', 'data/*.json']},
      python_requires='>=3.10',
      install_requires=['jax', 'numpy', 'scipy', 'torch'])
