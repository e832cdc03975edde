// The instances of K11a (filter_batch_tan.cuh) for Hes1 at q = 3, under
// kramer and rodeo.
#include "filter_batch_tan.cuh"

namespace rodeo {

template struct FilterBatchTanInstances<Hes1, 3>;

}  // namespace rodeo
